"""setup_s: seconds from the start of `run.py` to the first timed call
(imports, the kernels' build or load, weights and inputs, the warm-up)."""


def read(run):
    return run.setup_s
