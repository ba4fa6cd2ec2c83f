"""Registration error metrics, twin of `rift_tpu/registration/metrics.py`:
`pair_errors` (RRE, RTE, RMSE and the success rates of the DeepGMR
meter) and `rpmnet_metrics` (the RPM-Net family)."""
from __future__ import annotations

import torch

from ..ops import se3
from ..ops.losses import chamfer_distance
from ..ops.precision import f32_geometry

Tensor = torch.Tensor

# Success thresholds of the reference meter.
ROT_THRESH_DEG = 1e-5
TRANS_THRESH = 0.005
RMSE_THRESH = 0.2


def rpmnet_metrics(points_src: Tensor, points_ref: Tensor, gt_transform: Tensor,
                   est_transform: Tensor) -> dict:
    """The RPM-Net metric family of pairs: points_src [..., n, 3],
    points_ref [..., m, 3], transforms [..., 4, 4] -> dict of [...]-shaped
    r_mse (RRE², deg²), r_mae and err_r_deg (RRE, deg), t_mse (‖Δt‖²),
    t_mae (mean |Δt| over the axes), err_t (‖Δt‖) and chamfer (of the
    source moved by the estimate, against the reference)."""
    rre = se3.rotation_error_deg(se3.rot_of(gt_transform), se3.rot_of(est_transform))
    dt = se3.trans_of(gt_transform) - se3.trans_of(est_transform)
    aligned = se3.transform_points(est_transform, points_src)
    return {"r_mse": rre ** 2, "r_mae": rre,
            "t_mse": (dt ** 2).sum(-1), "t_mae": dt.abs().mean(-1),
            "err_r_deg": rre, "err_t": torch.linalg.vector_norm(dt, dim=-1),
            "chamfer": chamfer_distance(aligned, points_ref)}


@f32_geometry()
def pair_errors(points: Tensor, gt_transform: Tensor, est_transform: Tensor) -> dict:
    """points [..., n, 3]; transforms [..., 4, 4] -> dict of [...]-shaped
    metrics: rre (deg), rte, rmse, succ, rmse_succ."""
    rre = se3.rotation_error_deg(se3.rot_of(gt_transform), se3.rot_of(est_transform))
    rte = se3.translation_error(se3.trans_of(gt_transform), se3.trans_of(est_transform))
    rmse = se3.registration_rmse(points, gt_transform, est_transform)
    succ = (rre < ROT_THRESH_DEG) & (rte < TRANS_THRESH)
    return {"rre": rre, "rte": rte, "rmse": rmse,
            "succ": succ.to(torch.float32),
            "rmse_succ": (rmse < RMSE_THRESH).to(torch.float32)}
