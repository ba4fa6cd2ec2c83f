"""K2 voxel scatter-mean, K3 8-corner gather and K4 8-corner scatter: the
plain versions, frozen from the port's `ops/cuda/onehot_ops.py`, on any
device. An index outside [0, s) matches no voxel and drops out.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

def scatter_mean_plain(features: Tensor, inds: Tensor, num_segments: int
                       ) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version of K2: features [b, n, c] (f32, f64 or bf16),
    inds [b, n] (outside [0, s) = dropped) -> (out [b, s, c], cnt [b, s]),
    both f32 for bf16 features; empty voxels hold 0. Sums in point order,
    then scales by 1/count."""
    b, n, c = features.shape
    s = num_segments
    acc = torch.promote_types(features.dtype, torch.float32)
    valid = (inds >= 0) & (inds < s)
    # Dropped points go to a trash row past each cloud's segments.
    row = torch.where(valid, inds.long(), torch.full_like(inds.long(), s))
    flat = (row + torch.arange(b, device=inds.device)[:, None] * (s + 1)).reshape(-1)
    sums = torch.zeros((b * (s + 1), c), dtype=acc, device=features.device)
    sums.index_add_(0, flat, features.reshape(b * n, c).to(acc))
    cnt = torch.zeros(b * (s + 1), dtype=acc, device=features.device)
    cnt.index_add_(0, flat, valid.reshape(-1).to(acc))
    sums = sums.reshape(b, s + 1, c)[:, :s]
    cnt = cnt.reshape(b, s + 1)[:, :s]
    inv = torch.where(cnt > 0, 1.0 / torch.clamp(cnt, min=1.0), torch.zeros_like(cnt))
    return sums * inv[..., None], cnt


def corner_gather_plain(grid: Tensor, corner_idx: Tensor, corner_w: Tensor
                        ) -> Tensor:
    """Plain PyTorch version of K3: grid [b, s, c] (f32, f64 or bf16),
    corner_idx [b, n, 8] (outside [0, s) = skipped), corner_w [b, n, 8] ->
    out [b, n, c], f32 for a bf16 grid, the corners summed in k order."""
    b, n, _ = corner_idx.shape
    s, c = grid.shape[1:]
    acc = torch.promote_types(grid.dtype, torch.float32)
    out = torch.zeros((b, n, c), dtype=acc, device=grid.device)
    for k in range(8):
        idx = corner_idx[..., k]
        valid = (idx >= 0) & (idx < s)
        safe = torch.where(valid, idx, torch.zeros_like(idx)).long()
        rows = torch.gather(grid, 1, safe[..., None].expand(b, n, c)).to(acc)
        w = torch.where(valid, corner_w[..., k], torch.zeros_like(corner_w[..., k]))
        out = out + w[..., None] * rows
    return out


def corner_scatter_plain(dout: Tensor, corner_idx: Tensor, corner_w: Tensor,
                         num_segments: int) -> Tensor:
    """Plain PyTorch version of K4, the transpose of K3: dout [b, n, c],
    corner_idx [b, n, 8] (outside [0, s) = skipped), corner_w [b, n, 8] ->
    dgrid [b, s, c] with dgrid[v] = Σ_{p,k: idx = v} w[p, k]·dout[p]. The
    products are summed in (p, k) order (`index_add_` on the CPU)."""
    b, n, c = dout.shape
    s = num_segments
    valid = (corner_idx >= 0) & (corner_idx < s)
    # Skipped corners go to a trash row past each cloud's segments.
    row = torch.where(valid, corner_idx.long(), torch.full_like(corner_idx.long(), s))
    flat = (row + torch.arange(b, device=dout.device)[:, None, None] * (s + 1)).reshape(-1)
    rows = (corner_w.to(dout.dtype)[..., None] * dout[:, :, None, :]).reshape(b * n * 8, c)
    out = torch.zeros((b * (s + 1), c), dtype=dout.dtype, device=dout.device)
    out.index_add_(0, flat, rows)
    return out.reshape(b, s + 1, c)[:, :s]


scatter_mean = scatter_mean_plain
corner_gather = corner_gather_plain
corner_scatter = corner_scatter_plain
