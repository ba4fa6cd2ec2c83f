"""nccl_ms.train: device ms per step of NCCL's kernels (global BatchNorm's
all-reduces, the gradient and loss all-reduces) in rank 0's traced
window."""


def read(run):
    t = run.trace
    if t is None or t.calls == 0 or t.busy_s <= 0:  # no device operation traced
        return None
    seconds = t.device_seconds(lambda name: "nccl" in name.lower())
    return 1e3 * seconds / t.calls if seconds > 0 else None
