"""Batched pair registration.

- `register_batch`, twin of `bench.py:register_batch`: normals -> PVCNN
  features -> mutual-NN matches -> GNC-TLS pose, for every pair.
- `register_pair` and `register_pair_from_matches`, twins of
  `rift_tpu/registration/pipeline.py`, batched over pairs: features or
  given matches -> the robust solver of `method`, one of `METHODS`: the
  base solver 'ransac', 'fgr', 'teaserpp' or 'icp' (dense point-to-point
  ICP from the identity), and the first three with a dense refiner: '+icp'
  (point-to-point ICP), '+picp' (point-to-point, then point-to-plane ICP
  on the target's estimated normals with a 0.05 gate) or '+pl'
  (point-to-plane alone, gate 3·noise_bound). RANSAC draws from an
  explicit `torch.Generator` (one seeded with 0 on the points' device by
  default, as the reference uses `PRNGKey(0)`).
"""
from __future__ import annotations

import torch

from .. import tracing
from ..device import resolve_device
from ..ops.neighbors import gather_rows, mutual_nearest_neighbors
from ..ops.normals import estimate_normals
from ..ops.precision import f32_geometry
from .gnc import fgr_pose, gnc_pose, teaser_pose
from .icp import icp_plane_pose, icp_pose
from .ransac import ransac_pose

Tensor = torch.Tensor


NOISE_BOUND = 0.02  # GNC-TLS noise bound of bench.py and the reference
METHODS = ("ransac", "fgr", "teaserpp", "icp",
           "ransac+icp", "fgr+icp", "teaserpp+icp",
           "ransac+picp", "fgr+picp", "teaserpp+picp",
           "ransac+pl", "fgr+pl", "teaserpp+pl")
REFINERS = ("+icp", "+picp", "+pl")


def split_method(method: str) -> tuple[str, str | None]:
    """'ransac+picp' -> ('ransac', '+picp'); raises on a name outside
    METHODS."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of {METHODS}")
    for suffix in REFINERS:
        if method.endswith(suffix):
            return method[: -len(suffix)], suffix
    return method, None


@f32_geometry()
def register_pair_from_matches(pts1: Tensor, pts2: Tensor, idx1: Tensor, idx2: Tensor,
                               mask: Tensor, method: str = "teaserpp",
                               noise_bound: float = NOISE_BOUND, inlier_threshold: float = 0.08,
                               num_hypotheses: int = 512, irls_iterations: int = 3,
                               irls_shrink: float = 1.0,
                               generator: torch.Generator | None = None
                               ) -> tuple[Tensor, Tensor]:
    """Robust pose from given matches, for b pairs: pts1 [b, n, 3], pts2
    [b, m, 3], matches (idx1, idx2, mask) [b, k] -> (transform [b, 4, 4]
    mapping pts1 onto pts2, inlier mask [b, k]; all ones for 'icp', which
    ignores the matches)."""
    base, refine = split_method(method)
    with tracing.span("register.pose", pts1.device):
        if base == "icp":
            return icp_pose(pts1, pts2), torch.ones_like(mask, dtype=torch.bool)
        src, dst = gather_rows(pts1, idx1), gather_rows(pts2, idx2)
        if base == "teaserpp":
            transform, w = teaser_pose(src, dst, mask, noise_bound=noise_bound)
            inliers = w > 0.5
        elif base == "fgr":
            transform, w = fgr_pose(src, dst, mask, noise_bound=2 * noise_bound)
            inliers = w > 0.5
        else:
            if generator is None:
                generator = torch.Generator(device=src.device).manual_seed(0)
            transform, inliers = ransac_pose(src, dst, mask, generator,
                                             num_hypotheses=num_hypotheses,
                                             inlier_threshold=inlier_threshold,
                                             irls_iterations=irls_iterations,
                                             irls_shrink=irls_shrink)
        return refine_pose(pts1, pts2, transform, refine, noise_bound), inliers


def refine_pose(pts1: Tensor, pts2: Tensor, transform: Tensor, refiner: str | None,
                noise_bound: float = NOISE_BOUND) -> Tensor:
    """The dense refiner of a method name from `transform` [b, 4, 4]: None
    (the transform as it is), '+icp', '+picp' or '+pl'. Strict f32 is the
    caller's to set."""
    if refiner == "+icp":
        return icp_pose(pts1, pts2, init_transform=transform)
    if refiner == "+picp":
        # Point-to-point first (the wide 0.2 gate tolerates a coarse start),
        # then point-to-plane with a tight gate near the optimum.
        transform = icp_pose(pts1, pts2, init_transform=transform)
        return icp_plane_pose(pts1, pts2, estimate_normals(pts2), init_transform=transform,
                              max_correspondence_distance=0.05)
    if refiner == "+pl":
        return icp_plane_pose(pts1, pts2, estimate_normals(pts2), init_transform=transform,
                              max_correspondence_distance=3.0 * noise_bound)
    return transform


def register_pair(pts1: Tensor, pts2: Tensor, feat1: Tensor, feat2: Tensor,
                  method: str = "teaserpp", noise_bound: float = NOISE_BOUND,
                  inlier_threshold: float = 0.08, num_hypotheses: int = 512,
                  irls_iterations: int = 3, irls_shrink: float = 1.0,
                  generator: torch.Generator | None = None) -> tuple[Tensor, Tensor]:
    """Mutual-NN matches of the features [b, n, c] and [b, m, c], then
    `register_pair_from_matches`: -> (transform [b, 4, 4], inliers [b, n]);
    'icp' skips the matching."""
    if split_method(method)[0] == "icp":
        with f32_geometry():
            return icp_pose(pts1, pts2), torch.ones(pts1.shape[:2], dtype=torch.bool,
                                                    device=pts1.device)
    with tracing.span("register.match", feat1.device):
        idx1, idx2, mask = mutual_nearest_neighbors(feat1, feat2)
    return register_pair_from_matches(pts1, pts2, idx1.expand(idx2.shape), idx2, mask,
                                      method, noise_bound, inlier_threshold, num_hypotheses,
                                      irls_iterations, irls_shrink, generator)


def register_batch(model: torch.nn.Module, src, dst, device=None,
                   early_exit: bool = True) -> Tensor:
    """Estimated transforms [b, 4, 4] (src -> dst) for b pairs of clouds.

    src, dst: [b, n, 3] arrays or tensors. `model` is an eval-mode
    `PVCNNClassifier` already on `device`, f32 (the flagship) or bf16
    (`models.bench_model`, bench.py's model); either returns f32 features.
    `device=None` means the CUDA card and raises when there is none;
    `device="cpu"` runs the plain PyTorch versions of the kernels. The
    geometry is strict f32: TF32 is turned off for matmuls and cuDNN
    convolutions (`ops/precision.py:f32_geometry`). `early_exit` is
    `gnc_pose`'s TLS schedule (bench.py's `BENCH_GNC_EARLY_EXIT`): False
    runs its 100 iterations with no host read, to the same transforms.
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
        with tracing.span("register.features", device):
            clouds = torch.cat([src, dst], dim=0)  # both clouds in one forward
            x = torch.cat([clouds, estimate_normals(clouds)], dim=-1)
            feats = model(x)
        with tracing.span("register.match", device):
            _, idx2, mask = mutual_nearest_neighbors(feats[:b], feats[b:])
        with tracing.span("register.pose", device):
            matched = torch.gather(dst, 1, idx2[..., None].expand(-1, -1, 3))
            transform, _ = gnc_pose(src, matched, mask, noise_bound=NOISE_BOUND,
                                    early_exit=early_exit)
    return transform
