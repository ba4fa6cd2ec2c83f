"""mfu.register: the model FLOPs of a registration call (`costs.register_flops`:
normals, the trunk on 2b clouds or the flagship's 5b, the matchings; the
pose solve left out) over the traced window's seconds per call times the
configuration's dtype peak (989e12 bf16, 67e12 f32 on the H100 SXM), in %."""

from benchmark import costs


def read(run):
    t = run.trace
    if t is None or t.calls == 0 or t.busy_s <= 0:  # no device operation traced
        return None
    cfg, tr = run.spec.config, run.spec.traffic
    flips = tr["driver"] == "register_eval_batch" and cfg["evaluate"]["flip_hypotheses"]
    flops = costs.register_flops(cfg["model"], tr["pairs"], tr["points"], flips)
    peak = costs.peaks_for_name(run.device_name).flops(cfg["model"].get("dtype"))
    return 100.0 * flops / (t.window_s / t.calls * peak)
