"""K5's plain version, frozen from the port's `ops/cuda/conv3d.py`: the 3×3×3
SAME Conv3d of the bf16 eval voxel branch. x [b, r, r, r, cin] bf16
channels-last and w [cout, cin, 3, 3, 3] bf16 are upcast to f32 (every
bf16 product is exact in f32), convolved once in f32 with TF32 off, and
the result rounded to bf16. Under the fp8 control
(`ops/precision.py:lower_precision`) both operands are first rounded to
fp8.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from ..precision import f32_geometry, low

Tensor = torch.Tensor


def conv3d_same(x: Tensor, w: Tensor) -> Tensor:
    """x [b, r, r, r, cin] bf16, w [cout, cin, 3, 3, 3] bf16 -> [b, r, r, r,
    cout] bf16."""
    x, w = low(x), low(w)
    with f32_geometry():
        y = F.conv3d(x.permute(0, 4, 1, 2, 3).float(), w.float(), padding=1)
    return y.permute(0, 2, 3, 4, 1).to(torch.bfloat16).contiguous()


def padded_bf16(x: Tensor) -> Tensor:
    """x as bf16 (the port pads the voxel stride for its kernel's loads;
    the values are the same)."""
    return x.to(torch.bfloat16)
