"""The autograd Functions of the voxel grids, spherical and cube
(`ops/spherical.py`, `ops/voxelize.py`): the scatter-mean K2 and the
8-corner gather K3 with their backwards.

Twins of the custom VJPs of `rift_tpu/ops/pallas/spherical_fast.py` (and of
JAX's own transposes on the cube path): the scatter-mean's backward is the
row gather dfeat[p] = g[ind[p]] / cnt[ind[p]] (0 for dropped points), plain
PyTorch; the corner gather's backward for the grid is K4, its transpose.
Indices, corner weights and counts get no gradient. On CPU tensors the
wrappers take their plain versions, forward and backward alike.

K2 and K3 write f32 for a bf16 input, and K4 takes an f32 cotangent, so
in bf16 training each backward forms an f32 gradient for a bf16 input; it
rounds it to the input's type itself, as the reference's convert does in
its transpose, rather than leaving the cast to the autograd engine.
"""
from __future__ import annotations

import torch

from .plain.onehot_ops import corner_gather, corner_scatter, scatter_mean


class ScatterMean(torch.autograd.Function):
    """(features [b, n, c], inds [b, n], s) -> (out [b, s, c], cnt [b, s]);
    forward K2, backward a row gather. `cnt` takes no gradient."""

    @staticmethod
    def forward(ctx, features, inds, num_segments):
        out, cnt = scatter_mean(features, inds, num_segments)
        ctx.save_for_backward(inds, cnt)
        ctx.mark_non_differentiable(cnt)
        ctx.dtype = features.dtype
        return out, cnt

    @staticmethod
    def backward(ctx, g, _):
        inds, cnt = ctx.saved_tensors
        valid = (inds >= 0) & (inds < g.shape[1])
        safe = torch.where(valid, inds.long(), torch.zeros_like(inds.long()))
        g_rows = torch.gather(g, 1, safe[..., None].expand(-1, -1, g.shape[-1]))
        inv = 1.0 / torch.clamp(torch.gather(cnt, 1, safe), min=1.0)
        inv = torch.where(valid, inv, torch.zeros_like(inv))
        return (g_rows * inv[..., None]).to(ctx.dtype), None, None


class CornerGather(torch.autograd.Function):
    """(grid [b, s, c], corner_idx [b, n, 8], corner_w [b, n, 8]) ->
    [b, n, c]; forward K3, backward for the grid K4. The corners and their
    weights take no gradient."""

    @staticmethod
    def forward(ctx, grid, corner_idx, corner_w):
        ctx.save_for_backward(corner_idx, corner_w)
        ctx.num_segments = grid.shape[1]
        ctx.dtype = grid.dtype
        return corner_gather(grid, corner_idx, corner_w)

    @staticmethod
    def backward(ctx, g):
        corner_idx, corner_w = ctx.saved_tensors
        g_grid = corner_scatter(g.contiguous(), corner_idx, corner_w, ctx.num_segments)
        return g_grid.to(ctx.dtype), None, None
