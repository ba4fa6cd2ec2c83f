"""Batched pair registration, twin of `bench.py:register_batch`: normals ->
PVCNN features -> mutual-NN matches -> GNC-TLS pose, for every pair."""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..ops.neighbors import mutual_nearest_neighbors
from ..ops.normals import estimate_normals
from ..ops.precision import f32_geometry
from .gnc import gnc_pose

Tensor = torch.Tensor


NOISE_BOUND = 0.02  # GNC-TLS noise bound of bench.py and the reference


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
