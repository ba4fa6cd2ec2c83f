"""The SE(3) pieces the registration metrics and the point-to-plane ICP
use, twin of `rift_tpu/ops/se3.py` (hat, _sinc_coeffs, exp_so3, rot_of,
trans_of, transform_points, rotation_error_deg, translation_error,
registration_rmse)."""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def hat(w: Tensor) -> Tensor:
    """Skew-symmetric matrix of w: [..., 3] -> [..., 3, 3]."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
    ], dim=-2)


def _sinc_coeffs(theta2: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """(sinθ/θ, (1 − cosθ)/θ², (θ − sinθ)/θ³) from θ², by their Taylor
    series where θ² < 1e-8."""
    small = theta2 < 1e-8
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe2)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (safe2 * theta))
    return a, b, c


def exp_so3(w: Tensor) -> Tensor:
    """Rodrigues: axis-angle [..., 3] -> rotation matrix [..., 3, 3]."""
    theta2 = (w * w).sum(-1)[..., None, None]
    a, b, _ = _sinc_coeffs(theta2)
    k = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(k.shape)
    return eye + a * k + b * torch.matmul(k, k)


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
