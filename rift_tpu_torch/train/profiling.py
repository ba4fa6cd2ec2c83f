"""Profiling and tracing, twin of `rift_tpu/train/profiling.py`: `trace`,
`annotate` and `StepTimer`, which live in `rift_tpu_torch/tracing.py`
beside the recorder of the registration path's spans and counters."""
from ..tracing import StepTimer, annotate, trace  # noqa: F401
