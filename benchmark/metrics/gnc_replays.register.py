"""gnc_replays.register: the program's counter `gnc.graph_replays` a call:
the replays of GNC-TLS's fixed schedule as one captured CUDA graph
(`gnc_pose`'s fixed schedule on a card, outside autograd and any other
capture; the early exit and TEASER's polish run eagerly and add nothing),
as the program's recorder (`rift_tpu_torch/tracing.py`) counts them in the
traced window, divided by the window's calls. A counter never added to
reads 0 where the window recorded the program's spans; None without a
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
    return snap["counters"].get("gnc.graph_replays", 0) / t.calls
