"""forward_ms.train: device ms a step of the program's span `train.forward`,
the training step's train-mode forward, its loss and its accuracy
(`train/steps.py:forward_backward`): its extent on the card's stream between
the two timing events that the program's recorder
(`rift_tpu_torch/tracing.py`) puts around it, summed over the traced window
and divided by its calls. None without a trace, or where the program has no
recorder or the span did not run."""


def read(run):
    t = run.trace
    if t is None or t.calls == 0:
        return None
    try:
        from rift_tpu_torch import tracing
    except ImportError:  # a program without the recorder
        return None
    span = tracing.snapshot()["spans"].get("train.forward")
    if span is None or span["device_s"] is None:
        return None
    return 1e3 * span["device_s"] / t.calls
