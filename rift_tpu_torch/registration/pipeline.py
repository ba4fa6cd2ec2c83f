"""Batched pair registration.

- `register_batch`, twin of `bench.py:register_batch`: normals -> PVCNN
  features -> mutual-NN matches -> GNC-TLS pose, for every pair.
- `register_pair` and `register_pair_from_matches`, twins of
  `rift_tpu/registration/pipeline.py`, batched over pairs: features or
  given matches -> the robust solver of `method`. Only 'teaserpp' is
  ported (`gnc.teaser_pose`); 'ransac', 'fgr', 'icp' and the '+icp',
  '+picp', '+pl' refiners wait for their slice (ROADMAP item 8).
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..ops.neighbors import gather_rows, mutual_nearest_neighbors
from ..ops.normals import estimate_normals
from ..ops.precision import f32_geometry
from .gnc import gnc_pose, teaser_pose

Tensor = torch.Tensor


NOISE_BOUND = 0.02  # GNC-TLS noise bound of bench.py and the reference


def check_method(method: str) -> None:
    """Raise unless `method` is the one that is ported ('teaserpp')."""
    if method != "teaserpp":
        raise NotImplementedError(f"method {method!r} is not ported yet; only 'teaserpp' "
                                  "is (ROADMAP item 8)")


@f32_geometry()
def register_pair_from_matches(pts1: Tensor, pts2: Tensor, idx1: Tensor, idx2: Tensor,
                               mask: Tensor, method: str = "teaserpp",
                               noise_bound: float = NOISE_BOUND) -> tuple[Tensor, Tensor]:
    """Robust pose from given matches, for b pairs: pts1 [b, n, 3], pts2
    [b, m, 3], matches (idx1, idx2, mask) [b, k] -> (transform [b, 4, 4]
    mapping pts1 onto pts2, inlier mask [b, k])."""
    check_method(method)
    transform, w = teaser_pose(gather_rows(pts1, idx1), gather_rows(pts2, idx2), mask,
                               noise_bound=noise_bound)
    return transform, w > 0.5


def register_pair(pts1: Tensor, pts2: Tensor, feat1: Tensor, feat2: Tensor,
                  method: str = "teaserpp", noise_bound: float = NOISE_BOUND
                  ) -> tuple[Tensor, Tensor]:
    """Mutual-NN matches of the features [b, n, c] and [b, m, c], then
    `register_pair_from_matches`: -> (transform [b, 4, 4], inliers [b, n])."""
    idx1, idx2, mask = mutual_nearest_neighbors(feat1, feat2)
    return register_pair_from_matches(pts1, pts2, idx1.expand(idx2.shape), idx2, mask,
                                      method, noise_bound)


def register_batch(model: torch.nn.Module, src, dst, device=None) -> Tensor:
    """Estimated transforms [b, 4, 4] (src -> dst) for b pairs of clouds.

    src, dst: [b, n, 3] arrays or tensors. `model` is an eval-mode
    `PVCNNClassifier` already on `device`, f32 (the flagship) or bf16
    (`models.bench_model`, bench.py's model); either returns f32 features.
    `device=None` means the CUDA card and raises when there is none;
    `device="cpu"` runs the plain PyTorch versions of the kernels. The
    geometry is strict f32: TF32 is turned off for matmuls and cuDNN
    convolutions (`ops/precision.py:f32_geometry`).
    """
    device = resolve_device(device)
    if model.training:
        raise ValueError("register_batch needs the model in eval mode")
    p = next(model.parameters())
    if p.device.type != device.type:
        raise ValueError(f"model is on {p.device}, the run on {device}")
    src = torch.as_tensor(src, dtype=torch.float32, device=device)
    dst = torch.as_tensor(dst, dtype=torch.float32, device=device)
    b = src.shape[0]
    with torch.no_grad(), f32_geometry():
        clouds = torch.cat([src, dst], dim=0)  # both clouds in one forward
        x = torch.cat([clouds, estimate_normals(clouds)], dim=-1)
        feats = model(x)
        _, idx2, mask = mutual_nearest_neighbors(feats[:b], feats[b:])
        matched = torch.gather(dst, 1, idx2[..., None].expand(-1, -1, 3))
        transform, _ = gnc_pose(src, matched, mask, noise_bound=NOISE_BOUND)
    return transform
