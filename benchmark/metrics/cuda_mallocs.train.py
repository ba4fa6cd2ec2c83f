"""cuda_mallocs.train: the program's counter `cuda.mallocs` a training step,
the caching allocator's new device allocations (cudaMalloc) inside the
program's top-level spans (`train.forward`, `train.backward`,
`train.update`), as the program's recorder (`rift_tpu_torch/tracing.py`)
counts it in the traced window, divided by the window's calls. A counter
never added to reads 0 where the window recorded the program's spans; None
without a trace, or where the program has no recorder or recorded nothing."""


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
    return snap["counters"].get("cuda.mallocs", 0) / t.calls
