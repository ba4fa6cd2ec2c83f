"""launches_per_batch.register: kernel launches the host made per call in the
traced window (`cudaLaunchKernel`, `cudaLaunchKernelExC` and the driver's;
a CUDA graph replay counts one)."""


def read(run):
    t = run.trace
    if t is None or t.calls == 0 or t.busy_s <= 0:  # no device operation traced
        return None
    return t.launches / t.calls
