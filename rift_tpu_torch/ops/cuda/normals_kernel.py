"""K1: hybrid-radius neighbourhood moments (CUDA kernel and plain version).

Twin of `rift_tpu/ops/pallas/normals_kernel.py:neighborhood_moments_pallas`
(its `_moments_kernel`). For each query i: d²(i, j) = (|q|² + |p|²) − 2·q·p
clamped at 0; `lo`, `hi` from 32 bisection steps by counting from
[0, max d²] and kth = the min of the d² inside (lo, hi] (empty -> 0);
r² = max(radius², kth·(1 + 1e-6)) (k = 0: fixed radius); then Σp, Σp⊗p
and the count over the j with d² < r².

The kernel, `csrc/normals_moments.cu`, reaches the same r² without the
bisection's 32 passes over d²: each step asks count(d² <= mid) >= k, which
holds exactly when the exact k-th smallest d² is <= mid, so it selects that
value once (a bitonic sort of the few d² under a threshold, or a radix
select on their bits), replays the 32 steps on it and takes the bracket's
min in one pass (`hybrid_radius_sq_by_select` is that algorithm in torch,
for the tests). It sums the moments over a compacted neighbour list. Its
bound is operations, about 11 a (query, point) and 22 a neighbour; no
tensor cores, since only unfused f32 d² keeps the neighbour sets equal to
the plain version's. One launch per call, any n (clouds of up to 1024
points keep their d² in registers, larger ones form them again on each of
about 3 passes). `neighborhood_moments` launches it for a CUDA tensor and
takes `neighborhood_moments_plain` only for a CPU tensor.
"""
from __future__ import annotations

import torch

from . import build

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


def hybrid_radius_sq_by_select(d2: Tensor, k: int, radius_sq: float) -> Tensor:
    """`_hybrid_radius_sq` by K1's algorithm: the exact k-th smallest d²
    (`torch.kthvalue`; +inf when k exceeds the points), the 32 bisection
    steps replayed on that one value per query (count(d² <= mid) >= k is
    kth <= mid), then the min in (lo, hi]. The same bits as the bisection by
    counting; for the tests."""
    if k <= 0:
        return torch.full(d2.shape[:-1], radius_sq, dtype=d2.dtype, device=d2.device)
    n = d2.shape[-1]
    have = k <= n
    kth = (torch.kthvalue(d2, k, dim=-1).values if have
           else torch.full(d2.shape[:-1], float("inf"), dtype=d2.dtype, device=d2.device))
    lo = torch.zeros(d2.shape[:-1], dtype=d2.dtype, device=d2.device)
    hi = d2.amax(-1)
    for _ in range(_BISECT_STEPS):
        mid = 0.5 * (lo + hi)
        pred = (kth <= mid) & have
        lo = torch.where(pred, lo, mid)
        hi = torch.where(pred, mid, hi)
    return _bracket_radius_sq(d2, lo, hi, radius_sq)


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


def neighborhood_moments(points: Tensor, k: int, radius_sq: float
                         ) -> tuple[Tensor, Tensor, Tensor]:
    """K1. points [b, n, 3] f32 -> (s1 [b, n, 3], s2 [b, n, 3, 3],
    cnt [b, n]). CPU tensor: the plain version; CUDA tensor: the kernel."""
    if points.device.type == "cpu":
        return neighborhood_moments_plain(points, k, radius_sq)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    if points.dtype != torch.float32 or points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"points must be f32 [b, n, 3], got {points.dtype} "
                         f"{tuple(points.shape)}")
    b, n, _ = points.shape
    lib = build.load()
    pts = points.contiguous()
    out = torch.empty((b, n, 13), dtype=torch.float32, device=points.device)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    build.check(lib.rift_normals_moments(pts.data_ptr(), out.data_ptr(), b, n,
                                         int(k), float(radius_sq), stream),
                "rift_normals_moments")
    neighborhood_moments.launches += 1
    return out[..., :3], out[..., 3:12].reshape(b, n, 3, 3), out[..., 12]


neighborhood_moments.launches = 0
