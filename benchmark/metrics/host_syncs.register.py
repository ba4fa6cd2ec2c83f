"""host_syncs.register: the program's counter `host.syncs` a call: the
registration path's reads of a device value on the host, each a sync on the
card (`gnc_pose`'s early-exit test, once before each iteration and once more
where every pair stops early; the PCA frame's `eigh`, which reads its error
codes), as the program's recorder (`rift_tpu_torch/tracing.py`) counts them
in the traced window, divided by the window's calls. A counter never added
to reads 0 where the window recorded the program's spans; None without a
trace, or where the program has no recorder or recorded nothing."""


def read(run):
    t = run.trace
    if t is None or t.calls == 0:
        return None
    try:
        from rift_tpu_torch import tracing
    except ImportError:  # a program without the recorder
        return None
    snap = tracing.snapshot()
    if not snap["spans"]:  # nothing recorded in the window
        return None
    return snap["counters"].get("host.syncs", 0) / t.calls
