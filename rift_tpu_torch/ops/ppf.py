"""Point-pair features, twin of `rift_tpu/ops/ppf.py` (`ppf`, `global_ppf`,
`local_ppf`).

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
