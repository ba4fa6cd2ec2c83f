"""k5_roofline.register: K5's (`csrc/conv3d.cu`, `conv3d_wgmma_kernel`) least
time at each launch's shapes (`costs.k5_bound_s`: the 4 convolutions of a
bf16 forward on 2b clouds) over its device time in the traced window, in %."""

from benchmark import costs

KERNEL = "conv3d_wgmma_kernel"


def read(run):
    t = run.trace
    if t is None or t.calls == 0 or t.busy_s <= 0:  # no device operation traced
        return None
    seconds = t.device_seconds(lambda name: KERNEL in name)
    if seconds <= 0:
        return None
    cfg, tr = run.spec.config, run.spec.traffic
    bound = costs.k5_bound_s(cfg["model"], 2 * tr["pairs"], costs.peaks_for_name(run.device_name))
    return 100.0 * bound * t.calls / seconds
