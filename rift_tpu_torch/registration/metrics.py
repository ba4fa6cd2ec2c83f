"""Registration error metrics, twin of
`rift_tpu/registration/metrics.py:pair_errors`."""
from __future__ import annotations

import torch

from ..ops import se3
from ..ops.precision import f32_geometry

Tensor = torch.Tensor

# Success thresholds of the reference meter.
ROT_THRESH_DEG = 1e-5
TRANS_THRESH = 0.005
RMSE_THRESH = 0.2


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
