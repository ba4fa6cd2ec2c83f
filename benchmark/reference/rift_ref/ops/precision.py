"""Precision of the reference, and the switch of its controls.

`f32_geometry`, frozen from the port's `ops/precision.py`: TF32 off for
matmuls and cuDNN inside the context, restored on exit. `lower_precision`
runs the reference one step below the configuration's precision, as the
benchmark's control does: "tf32" turns TF32 on where `f32_geometry`
would turn it off (the f32 configurations); "fp8" does that for the f32
geometry too, and rounds both operands of every bf16 Dense and Conv3d to
float8 e4m3 with a per-tensor scale (the bf16 configurations, whose
geometry is f32). `low` applies the fp8 rounding where it is on.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

_LOWER: contextvars.ContextVar[str | None] = contextvars.ContextVar("lower", default=None)
LOWER_MODES = ("tf32", "fp8")
FP8_MAX = 448.0  # the largest finite float8 e4m3fn


@contextlib.contextmanager
def lower_precision(mode: str | None):
    """Within the context the reference computes in `mode` (None: as the
    configuration states)."""
    if mode is not None and mode not in LOWER_MODES:
        raise ValueError(f"unknown lower precision {mode!r}; expected one of {LOWER_MODES}")
    token = _LOWER.set(mode)
    try:
        yield
    finally:
        _LOWER.reset(token)


def low(x: torch.Tensor) -> torch.Tensor:
    """x rounded to fp8 e4m3 (scaled so its largest magnitude is FP8_MAX)
    and back to its type under the "fp8" control; x itself otherwise."""
    if _LOWER.get() != "fp8":
        return x
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


@contextlib.contextmanager
def f32_geometry():
    """Context (and decorator) that turns TF32 off for matmuls and cuDNN,
    or on under the "tf32" control."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    tf32 = _LOWER.get() in LOWER_MODES
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
