"""Point-pair features, twin of `rift_tpu/ops/ppf.py` (`ppf`, `global_ppf`,
`local_ppf`, `new_ppf`).

Channels-last; points [..., n, 3].
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

_NORMAL_EPS = 1e-10


def _safe_unit(v: Tensor, eps: float) -> tuple[Tensor, Tensor]:
    """(unit vector, norm); zero vectors stay zero."""
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(norm, min=eps), norm[..., 0]


def _angle(a: Tensor, b: Tensor) -> Tensor:
    return torch.arccos(torch.clamp((a * b).sum(-1), -1.0, 1.0))


def ppf(coords: Tensor, centers: Tensor, normals: Tensor,
        center_normals: Tensor) -> Tensor:
    """PPF of each point vs its paired center, [..., n, 4]:
    (∠(d̂, n_center), ∠(d̂, n_point), ∠(n_center, n_point), ‖d‖) with
    d = center − point; zero where either normal has norm <= 1e-10."""
    d = centers - coords
    d_norm = torch.linalg.vector_norm(d, dim=-1)
    d_unit = d / torch.clamp(d_norm[..., None], min=1e-20)
    n1, n1_norm = _safe_unit(center_normals, _NORMAL_EPS)
    n2, n2_norm = _safe_unit(normals, _NORMAL_EPS)
    feat = torch.stack([_angle(d_unit, n1), _angle(d_unit, n2), _angle(n1, n2),
                        d_norm], dim=-1)
    defined = (n1_norm > _NORMAL_EPS) & (n2_norm > _NORMAL_EPS)
    return torch.where(defined[..., None], feat, torch.zeros_like(feat))


def global_ppf(coords: Tensor, normals: Tensor) -> Tensor:
    """PPF of every point against the cloud's centroid and its mean normal,
    [..., n, 4]; the normals are unit-normalized first (norm floor 1e-12)."""
    normals = normals / torch.clamp(torch.linalg.vector_norm(normals, dim=-1, keepdim=True),
                                    min=1e-12)
    centers = coords.mean(-2, keepdim=True).expand(coords.shape)
    center_normals = normals.mean(-2, keepdim=True).expand(normals.shape)
    return ppf(coords, centers, normals, center_normals)


def local_ppf(neighbor_coords: Tensor, neighbor_normals: Tensor,
              center_coords: Tensor, center_normals: Tensor) -> Tensor:
    """Per-neighbourhood PPF, [..., n, k, 4]:
    (∠(n_nbr, d̂), ∠(n_ctr, d̂), ∠(n_nbr, n_ctr), ‖d‖), d = center − neighbour."""
    d = center_coords[..., None, :] - neighbor_coords
    d_norm = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    d_unit = d / torch.clamp(d_norm, min=1e-20)
    nc = center_normals[..., None, :].expand(d_unit.shape)
    return torch.stack([_angle(neighbor_normals, d_unit), _angle(nc, d_unit),
                        _angle(neighbor_normals, nc), d_norm[..., 0]], dim=-1)


def new_ppf(coords: Tensor, normals: Tensor) -> Tensor:
    """The 'new_ppf' preprocess, [..., n, 5]: `global_ppf` and, per point,
    the median over every point of the angle between the two points'
    projections onto the plane normal to the mean normal (an angle of at
    most 1e-5, the point itself among them, counts as 100). As in the
    reference, the projection subtracts (p·n̂)·n̄ with n̄ the mean normal
    *unnormalised*; the median of an even count is the mean of the two
    middle values, as `jnp.median` takes it. The angle matrix is
    [..., n, n] (with its [..., n, n, 3] cross products)."""
    unit = normals / torch.clamp(torch.linalg.vector_norm(normals, dim=-1, keepdim=True),
                                 min=1e-12)
    old = global_ppf(coords, normals)
    center_normals = unit.mean(-2, keepdim=True)
    ncn = center_normals / torch.clamp(
        torch.linalg.vector_norm(center_normals, dim=-1, keepdim=True), min=1e-12)
    norm_coords = coords - coords.mean(-2, keepdim=True)
    proj = norm_coords - (norm_coords * ncn).sum(-1, keepdim=True) * center_normals
    cos_alpha = torch.matmul(proj, proj.transpose(-1, -2))
    sin_alpha = torch.linalg.vector_norm(
        torch.linalg.cross(proj[..., :, None, :], proj[..., None, :, :]), dim=-1)
    alpha = torch.atan2(sin_alpha, cos_alpha)
    alpha = torch.where(alpha <= 1e-5, torch.full_like(alpha, 100.0), alpha)
    srt = torch.sort(alpha, dim=-1).values
    n = srt.shape[-1]
    median = (srt[..., (n - 1) // 2] + srt[..., n // 2]) * 0.5
    return torch.cat([old, median[..., None]], dim=-1)
