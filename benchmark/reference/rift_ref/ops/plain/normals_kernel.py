"""K1's plain version, frozen from the port's `ops/cuda/normals_kernel.py`:
hybrid-radius neighbourhood moments. For each query i: d²(i, j) =
(|q|² + |p|²) − 2·q·p clamped at 0; `lo`, `hi` from 32 bisection steps by
counting from [0, max d²] and kth = the min of the d² inside (lo, hi]
(empty -> 0); r² = max(radius², kth·(1 + 1e-6)) (k = 0: fixed radius);
then Σp, Σp⊗p and the count over the j with d² < r². Plain PyTorch on
any device.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

_BISECT_STEPS = 32


def point_sqdist(q: Tensor, p: Tensor) -> Tensor:
    """d² [..., m, n] of 3-d points by the kernel's expansion, written out
    component by component so every product and sum rounds once, in the
    kernel's order: ((qx·px + qy·py) + qz·pz), |q|² + |p|², minus 2·cross."""
    qx, qy, qz = (q[..., :, None, i] for i in range(3))
    px, py, pz = (p[..., None, :, i] for i in range(3))
    q2 = (qx * qx + qy * qy) + qz * qz
    p2 = (px * px + py * py) + pz * pz
    cross = (qx * px + qy * py) + qz * pz
    return torch.clamp((q2 + p2) - 2.0 * cross, min=0.0)


def _hybrid_radius_sq(d2: Tensor, k: int, radius_sq: float) -> Tensor:
    """r² [..., m] from the bracket (lo, hi] left by 32 bisection steps by
    counting: the min of the d² inside it (0 when empty)."""
    if k <= 0:
        return torch.full(d2.shape[:-1], radius_sq, dtype=d2.dtype, device=d2.device)
    lo = torch.zeros(d2.shape[:-1], dtype=d2.dtype, device=d2.device)
    hi = d2.amax(-1)
    for _ in range(_BISECT_STEPS):
        mid = 0.5 * (lo + hi)
        pred = (d2 <= mid[..., None]).sum(-1) >= k
        lo = torch.where(pred, lo, mid)
        hi = torch.where(pred, mid, hi)
    return _bracket_radius_sq(d2, lo, hi, radius_sq)


def _bracket_radius_sq(d2: Tensor, lo: Tensor, hi: Tensor, radius_sq: float) -> Tensor:
    """max(radius², m·(1 + 1e-6)), m the min of the d² in (lo, hi] (0 when
    none is)."""
    inside = (d2 > lo[..., None]) & (d2 <= hi[..., None])
    low = torch.where(inside, d2, torch.full_like(d2, float("inf"))).amin(-1)
    low = torch.where(torch.isfinite(low), low, torch.zeros_like(low))
    grow = torch.tensor(1.0 + 1e-6, dtype=d2.dtype, device=d2.device)
    return torch.clamp(low * grow, min=radius_sq)


def neighborhood_moments_plain(points: Tensor, k: int, radius_sq: float,
                               query_chunk: int | None = None
                               ) -> tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version: points [b, n, 3] f32 -> (s1 [b, n, 3],
    s2 [b, n, 3, 3], cnt [b, n]). `query_chunk` bounds the queries whose
    [chunk, n] d² are held at once (all n by default), for large clouds."""
    b, n, _ = points.shape
    outer = (points[..., :, None] * points[..., None, :]).reshape(b, n, 9)
    rhs = torch.cat([points, outer, torch.ones_like(points[..., :1])], dim=-1)
    step = n if query_chunk is None else query_chunk
    parts = []
    for q0 in range(0, n, step):
        d2 = point_sqdist(points[:, q0:q0 + step], points)
        r2 = _hybrid_radius_sq(d2, k, radius_sq)
        mask = (d2 < r2[..., None]).to(points.dtype)
        parts.append(torch.matmul(mask, rhs))  # [b, chunk, 13]
    out = torch.cat(parts, dim=1)
    return out[..., :3], out[..., 3:12].reshape(b, n, 3, 3), out[..., 12]


neighborhood_moments = neighborhood_moments_plain
