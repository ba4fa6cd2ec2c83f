"""cudnn_conv_ms.train: device ms per step of the library's convolution
kernels (cuDNN's Conv3d forward and backward and their layout
transforms, by kernel name) in rank 0's
traced window."""

# cuDNN's convolution kernels and its layout transforms around them (its
# batch-norm kernels are not convolutions).
MARKS = ("xmma", "convolve", "fprop", "dgrad", "wgrad", "nchwtonhwc", "nhwctonchw")
OWN = "conv3d_wgmma_kernel"  # the port's K5, not the library's


def is_conv(name: str) -> bool:
    low = name.lower()
    return OWN not in name and any(m in low for m in MARKS)


def read(run):
    t = run.trace
    if t is None or t.calls == 0 or t.busy_s <= 0:  # no device operation traced
        return None
    seconds = t.device_seconds(is_conv)
    return 1e3 * seconds / t.calls if seconds > 0 else None
