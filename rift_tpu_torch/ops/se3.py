"""SE(3)/SO(3) math, twin of `rift_tpu/ops/se3.py`: hat, _sinc_coeffs,
exp_so3 and the Lie maps of the pose graph and bundle adjustment
(log_so3, _v_matrix, exp_se3, log_se3), make_se3, rot_of, trans_of,
inverse, concatenate, transform_points, rotation_error_deg,
translation_error, registration_rmse.

Every function broadcasts over leading dims, so it also runs per sample
under `torch.func.vmap`/`jacfwd` (the solves' Jacobians). The safe forms
of the reference are kept op for op: the unselected branch of each
`where` stays finite, and `log_so3` clips cos θ inside (−1, 1) with its
Taylor branch below θ = 1e-4. The 3 × 3 inverse of `log_se3` is
`inv_ex`, which reads no error code on the host."""
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


def log_so3(rot: Tensor) -> Tensor:
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3]. cos θ is
    clipped to (−1 + 1e-7, 1 − 1e-7), where arccos has a finite
    derivative; below θ = 1e-4, θ/(2 sin θ) is its series 0.5 + θ²/12."""
    # θ keeps a trailing dim of 1: under jacfwd a 0-d tensor's tangent
    # would be promoted to f64 by its python-scalar arithmetic.
    tr = torch.diagonal(rot, dim1=-2, dim2=-1).sum(-1, keepdim=True)
    cos = torch.clamp((tr - 1.0) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos)
    vee = torch.stack([rot[..., 2, 1] - rot[..., 1, 2],
                       rot[..., 0, 2] - rot[..., 2, 0],
                       rot[..., 1, 0] - rot[..., 0, 1]], dim=-1)
    small = theta < 1e-4
    safe_sin = torch.where(small, torch.ones_like(theta), torch.sin(theta))
    scale = torch.where(small, 0.5 + theta * theta / 12.0, theta / (2.0 * safe_sin))
    return vee * scale


def _v_matrix(w: Tensor) -> Tensor:
    """Left Jacobian V of SO(3), exp_se3's translation factor:
    I + (1 − cosθ)/θ²·K + (θ − sinθ)/θ³·K², K = hat(w)."""
    theta2 = (w * w).sum(-1)[..., None, None]
    _, b, c = _sinc_coeffs(theta2)
    k = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(k.shape)
    return eye + b * k + c * torch.matmul(k, k)


def exp_se3(xi: Tensor) -> Tensor:
    """se(3) exponential: twist [..., 6] (w | v) -> transform [..., 4, 4]."""
    w, v = xi[..., :3], xi[..., 3:]
    t = torch.matmul(_v_matrix(w), v[..., None])[..., 0]
    return make_se3(exp_so3(w), t)


def log_se3(transform: Tensor) -> Tensor:
    """SE(3) logarithm: [..., 4, 4] -> twist [..., 6] (w | v)."""
    w = log_so3(rot_of(transform))
    v_inv = torch.linalg.inv_ex(_v_matrix(w))[0]
    v = torch.matmul(v_inv, trans_of(transform)[..., None])[..., 0]
    return torch.cat([w, v], dim=-1)


def make_se3(rot: Tensor, t: Tensor) -> Tensor:
    """[..., 3, 3], [..., 3] -> [..., 4, 4]."""
    batch = torch.broadcast_shapes(rot.shape[:-2], t.shape[:-1])
    rot = rot.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([rot, t[..., :, None]], dim=-1)
    bottom = torch.cat([torch.zeros_like(t[..., None, :]), torch.ones_like(t[..., None, :1])],
                       dim=-1)  # [..., 1, 4] = (0, 0, 0, 1), made on the device
    return torch.cat([top, bottom], dim=-2)


def rot_of(transform: Tensor) -> Tensor:
    return transform[..., :3, :3]


def trans_of(transform: Tensor) -> Tensor:
    return transform[..., :3, 3]


def inverse(transform: Tensor) -> Tensor:
    """Inverse of SE(3) transforms [..., 4, 4]: (Rᵀ, −Rᵀt)."""
    rot_inv = rot_of(transform).transpose(-1, -2)
    t_inv = -torch.matmul(rot_inv, trans_of(transform)[..., None])[..., 0]
    return make_se3(rot_inv, t_inv)


def concatenate(a: Tensor, b: Tensor) -> Tensor:
    """Composition a @ b of [..., 4, 4] transforms."""
    return torch.matmul(a, b)


def transform_points(transform: Tensor, points: Tensor) -> Tensor:
    """Apply [..., 4, 4] to row-vector points [..., n, 3]."""
    return (torch.matmul(points, rot_of(transform).transpose(-1, -2))
            + trans_of(transform)[..., None, :])


def rotation_error_deg(gt_rot: Tensor, est_rot: Tensor, orthonormalize: bool = False
                       ) -> Tensor:
    """RRE in degrees: acos((tr(RgᵀRe) − 1)/2). `orthonormalize` first
    projects both onto SO(3) (the polar factor, `kabsch.rotation_from_h`):
    the trace misreads a rotation that is not orthonormal, as chained
    trajectory poses can be."""
    if orthonormalize:
        from ..registration.kabsch import rotation_from_h

        gt_rot = rotation_from_h(gt_rot)
        est_rot = rotation_from_h(est_rot)
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
