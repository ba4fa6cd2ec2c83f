"""Strict f32 for geometry and the feature forward.

Twin of `rift_tpu/ops/precision.py:f32_geometry`, which pins JAX's matmul
precision to HIGHEST. On the card the two TF32 switches play that role:
`torch.backends.cuda.matmul.allow_tf32` (off by default) and
`torch.backends.cudnn.allow_tf32`, which is ON by default and would run
every Conv3d in TF32 (about three decimal digits). Both are turned off
inside the context and restored on exit.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def f32_geometry():
    """Context (and decorator) that turns TF32 off for matmuls and cuDNN."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
