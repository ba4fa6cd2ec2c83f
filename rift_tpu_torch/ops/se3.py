"""The SE(3) pieces the registration metrics use, twin of
`rift_tpu/ops/se3.py` (rot_of, trans_of, transform_points,
rotation_error_deg, translation_error, registration_rmse)."""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def rot_of(transform: Tensor) -> Tensor:
    return transform[..., :3, :3]


def trans_of(transform: Tensor) -> Tensor:
    return transform[..., :3, 3]


def transform_points(transform: Tensor, points: Tensor) -> Tensor:
    """Apply [..., 4, 4] to row-vector points [..., n, 3]."""
    return (torch.matmul(points, rot_of(transform).transpose(-1, -2))
            + trans_of(transform)[..., None, :])


def rotation_error_deg(gt_rot: Tensor, est_rot: Tensor) -> Tensor:
    """RRE in degrees: acos((tr(RgᵀRe) − 1)/2)."""
    prod = torch.matmul(gt_rot.transpose(-1, -2), est_rot)
    cos = (torch.diagonal(prod, dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    return torch.arccos(torch.clamp(cos, -1.0, 1.0)).abs() * (180.0 / math.pi)


def translation_error(gt_t: Tensor, est_t: Tensor) -> Tensor:
    """RTE: ‖t_gt − t_est‖."""
    return torch.linalg.vector_norm(gt_t - est_t, dim=-1)


def registration_rmse(points: Tensor, gt_transform: Tensor,
                      est_transform: Tensor) -> Tensor:
    """Mean distance between the gt- and est-transformed clouds."""
    a = transform_points(est_transform, points)
    b = transform_points(gt_transform, points)
    return torch.linalg.vector_norm(a - b, dim=-1).mean(-1)
