"""Point-to-point and point-to-plane ICP, twins of
`rift_tpu/registration/icp.py` (`icp_pose`, `icp_plane_pose`), batched over
pairs.

Each iteration matches every moved source point to its nearest target
point (`pairwise_sqdist` and the first `argmin`), weights the matches
inside the distance gate 1 and the rest 0, and refits: a weighted Kabsch
(`icp_pose`), or one Gauss-Newton step of the point-to-plane residual
(`icp_plane_pose`). Both run a fixed number of iterations with no host
sync.

The plane step's 6×6 system blends in the point-to-point system only along
the directions the plane Hessian H leaves weak, through the soft projector
P = V·diag(g/(λ + g))·Vᵀ over H's eigenbasis, g = τ·max(λ_max, 1e-20). The
reference forms P from `jnp.linalg.eigh`; P is the same function as
g·(H + g·I)⁻¹, which needs only λ_max. `torch.linalg.eigh` and `solve`
check their error codes on the host, a sync on the card, so here λ_max
comes from repeated squaring of H (`_largest_eigenvalue`) and the two 6×6
systems from `torch.linalg.solve_ex`, which checks none.
"""
from __future__ import annotations

import torch

from ..ops.neighbors import gather_rows, pairwise_sqdist
from ..ops.se3 import exp_so3, transform_points
from .kabsch import weighted_kabsch

Tensor = torch.Tensor

# Squarings of the normalized plane Hessian in `_largest_eigenvalue`: the
# Rayleigh quotient then weighs eigenvalue λ by (λ/λ_max)^(2^16), so it is
# within λ_max/(2^16·e) ≈ 6e-6·λ_max of λ_max whatever the gap.
SQUARINGS = 16


def _identity(b: int, like: Tensor) -> Tensor:
    return torch.eye(4, dtype=like.dtype, device=like.device).expand(b, 4, 4)


def _nearest(moved: Tensor, dst: Tensor, max_distance: float) -> tuple[Tensor, Tensor]:
    """Nearest target index [b, n] of each moved source point and its
    weight, 1 inside the gate (d² < max_distance²) and 0 outside."""
    d2 = pairwise_sqdist(moved, dst)
    nn_idx = torch.argmin(d2, dim=-1)
    nn_d2 = torch.gather(d2, -1, nn_idx[..., None])[..., 0]
    return nn_idx, (nn_d2 < max_distance ** 2).to(moved.dtype)


def icp_pose(src: Tensor, dst: Tensor, init_transform: Tensor | None = None,
             max_correspondence_distance: float = 0.2, max_iterations: int = 50) -> Tensor:
    """src [b, n, 3], dst [b, m, 3] -> transform [b, 4, 4] (src onto dst),
    from `init_transform` (the identity by default). Strict f32 is the
    caller's to set."""
    transform = _identity(src.shape[0], src) if init_transform is None else init_transform
    for _ in range(max_iterations):
        nn_idx, w = _nearest(transform_points(transform, src), dst, max_correspondence_distance)
        transform = weighted_kabsch(src, gather_rows(dst, nn_idx), w)
    return transform


def _largest_eigenvalue(h: Tensor) -> Tensor:
    """λ_max [...] of symmetric positive semi-definite h [..., k, k]:
    h/tr(h) squared SQUARINGS times (renormalized by the trace), which
    leaves a multiple of the top eigenspace's projector, then its Rayleigh
    quotient tr(h·m)/tr(m). 0 for h = 0."""
    def trace(x):
        return torch.diagonal(x, dim1=-2, dim2=-1).sum(-1)[..., None, None]

    m = h / torch.clamp(trace(h), min=1e-30)
    for _ in range(SQUARINGS):
        m = torch.matmul(m, m)
        m = m / torch.clamp(trace(m), min=1e-30)
    return (trace(torch.matmul(h, m)) / torch.clamp(trace(m), min=1e-30))[..., 0, 0]


def icp_plane_pose(src: Tensor, dst: Tensor, dst_normals: Tensor,
                   init_transform: Tensor | None = None,
                   max_correspondence_distance: float = 0.2, max_iterations: int = 20,
                   damping: float = 1e-6, rank_tau: float = 1e-3) -> Tensor:
    """Point-to-plane ICP: src [b, n, 3], dst [b, m, 3], unit dst_normals
    [b, m, 3] -> transform [b, 4, 4]. Per iteration, Gauss-Newton on
    r_i = (p'_i − q_i)·n_i with Jacobian rows [p'_i × n_i, n_i], plus the
    point-to-point system projected onto the plane system's weak
    directions, damped; the rotation update is exp_so3(ω)·R. Strict f32
    is the caller's to set."""
    b = src.shape[0]
    transform = _identity(b, src) if init_transform is None else init_transform
    eye3 = torch.eye(3, dtype=src.dtype, device=src.device)
    eye6 = torch.eye(6, dtype=src.dtype, device=src.device)
    for _ in range(max_iterations):
        rot, t = transform[:, :3, :3], transform[:, :3, 3]
        moved = transform_points(transform, src)
        nn_idx, w = _nearest(moved, dst, max_correspondence_distance)
        q = gather_rows(dst, nn_idx)
        nrm = gather_rows(dst_normals, nn_idx)
        r = ((moved - q) * nrm).sum(-1)  # [b, n]
        jac = torch.cat([torch.linalg.cross(moved, nrm), nrm], dim=-1)  # [b, n, 6]
        jw = jac * w[..., None]
        h = torch.matmul(jw.transpose(-1, -2), jac)  # [b, 6, 6]
        g = torch.matmul(jw.transpose(-1, -2), r[..., None])[..., 0]  # [b, 6]
        # Point-to-point: r_p = p' − q, J_p = [−[p']ₓ | I], [b, n, 3, 6].
        skew = torch.linalg.cross(moved[..., None, :].expand(-1, -1, 3, 3),
                                  eye3.expand(moved.shape[:-1] + (3, 3)))  # row j: p' × e_j
        jp = torch.cat([skew, eye3.expand(skew.shape)], dim=-1)
        jpw = jp * w[..., None, None]
        h_pt = torch.einsum("bnij,bnik->bjk", jpw, jp)
        g_pt = torch.einsum("bnij,bni->bj", jpw, moved - q)
        gate = rank_tau * torch.clamp(_largest_eigenvalue(h), min=1e-20)[:, None, None]
        proj = gate * torch.linalg.solve_ex(h + gate * eye6, eye6.expand(b, 6, 6))[0]
        h = h + torch.matmul(torch.matmul(proj, h_pt), proj) + damping * eye6
        g = g + torch.matmul(proj, g_pt[..., None])[..., 0]
        delta = torch.linalg.solve_ex(h, -g)[0]  # [ω, dt]
        rot_d = exp_so3(delta[:, :3])
        new = torch.zeros_like(transform)
        new[:, :3, :3] = torch.matmul(rot_d, rot)
        new[:, :3, 3] = torch.matmul(rot_d, t[..., None])[..., 0] + delta[:, 3:]
        new[:, 3, 3] = 1.0
        transform = new
    return transform
