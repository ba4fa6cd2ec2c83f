"""Loss functions, twin of `rift_tpu/ops/losses.py`: `kl_loss` and
`huber_loss` (PVCNN's functional losses) and the symmetric
`chamfer_distance` of the RPM-Net metrics. Each is differentiable; the
chamfer distance's squared distances are `neighbors.pairwise_sqdist` in
strict f32 (`precision.f32_geometry`: no TF32 on the card)."""
from __future__ import annotations

import torch

from .neighbors import pairwise_sqdist
from .precision import f32_geometry

Tensor = torch.Tensor


def kl_loss(x: Tensor, y: Tensor) -> Tensor:
    """Mean over every element of y · (log y − log_softmax(x)) where y > 0
    (torch's `F.kl_div(log_softmax(x), y)` with mean reduction)."""
    logp = torch.log_softmax(x, dim=-1)
    return torch.where(y > 0, y * (torch.log(torch.clamp(y, min=1e-12)) - logp),
                       torch.zeros_like(logp)).mean()


def huber_loss(error: Tensor, delta: float = 1.0) -> Tensor:
    """Mean Huber (smooth-L1) of raw errors: ½e² where |e| <= delta, else
    delta·(|e| − ½delta)."""
    abs_err = error.abs()
    quad = 0.5 * error * error
    lin = delta * (abs_err - 0.5 * delta)
    return torch.where(abs_err <= delta, quad, lin).mean()


def chamfer_distance(a: Tensor, b: Tensor) -> Tensor:
    """Symmetric chamfer distance of a [..., n, 3] and b [..., m, 3]: the
    mean over a of the squared distance to the nearest point of b, plus the
    same from b -> [...]."""
    with f32_geometry():
        d = pairwise_sqdist(a, b)
    return d.amin(-1).mean(-1) + d.amin(-2).mean(-1)
