"""mfu.seg: 3 × the segmentation model's forward FLOPs of a step's batch
(`costs_seg.train_flops`) over the traced window's seconds per step times
the f32 peak (67e12 on the H100 SXM) times the cards, in %."""

from benchmark import costs, costs_seg


def read(run):
    t = run.trace
    if t is None or t.calls == 0 or t.busy_s <= 0:  # no device operation traced
        return None
    cfg, tr = run.spec.config, run.spec.traffic
    flops = costs_seg.train_flops(cfg["model"], tr["batch"], tr["points"])
    peak = costs.peaks_for_name(run.device_name).flops(cfg["model"].get("dtype"))
    return 100.0 * flops / (t.window_s / t.calls * peak * run.chips)
