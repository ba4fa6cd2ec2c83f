"""PVCNN rotation-invariant feature extractor, twin of
`rift_tpu/models/pvcnn.py:PVCNNClassifier` in eval with `is_classify=False`.

Ported: centring; the 'change_coords' preprocess (`lrf_kind` 'pca' or
'reference', no extra channels); the eval local-PPF branch (ball-query
grouping, `local_ppf`, SharedMLP [32, 64], max over the valid slots); the
backbone of spherical `pointnet_kernel` PVConv blocks and SharedMLP blocks.
The other branches raise NotImplementedError until a later slice ports them.

Submodules carry the flax module names (`SharedMLP_0`, `PVConv_0`, ...) in
`self.layers`, so `weights.from_flax` maps a flax tree by name alone.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from ..nn.pvconv import PVConv
from ..nn.shared_mlp import SharedMLP
from ..ops.lrf import change_coords, lrf_basis
from ..ops.neighbors import ball_query_group
from ..ops.ppf import local_ppf

DEFAULT_BLOCKS = ((64, 1, 32), (128, 1, 32), (256, 1, None), (512, 1, None))


class PVCNNClassifier(nn.Module):
    """Field names mirror `rift_tpu.models.PVCNNClassifier`. Input
    [b, n, 6] (xyz + normals) -> per-point features [b, n, last width].
    On the card, run it inside `ops/precision.py:f32_geometry` (as
    `register_batch` does): cuDNN runs Conv3d in TF32 by default."""

    def __init__(self, blocks: Sequence[tuple[int, int, int | None]] = DEFAULT_BLOCKS,
                 dim_k: int = 512,
                 point_kernel_formal: str = "pointnet_kernel",
                 voxel_shape: str = "spherical",
                 with_coeff: bool = True, with_se: bool = True,
                 extra_feature_channels: int = 0,
                 width_multiplier: float = 1.0,
                 voxel_resolution_multiplier: float = 1.0,
                 is_classify: bool = False,
                 rot_invariant_preprocess: str | None = "change_coords",
                 lrf_kind: str = "pca",
                 with_local_feat: str | None = "ppf",
                 local_radius: float = 0.3, local_neighbors: int = 128,
                 local_fuse_dim: int = 64):
        super().__init__()
        if is_classify:
            raise NotImplementedError("the classifier head is not ported yet")
        if rot_invariant_preprocess != "change_coords" or extra_feature_channels != 0:
            raise NotImplementedError(
                f"preprocess {rot_invariant_preprocess!r} with "
                f"{extra_feature_channels} extra channels is not ported yet")
        if with_local_feat not in ("ppf", None):
            raise NotImplementedError(f"local feature {with_local_feat!r} is not ported yet")
        del dim_k  # the last block's width is the feature width, as in the reference
        self.lrf_kind = lrf_kind
        self.local_radius = local_radius
        self.local_neighbors = local_neighbors
        layers = {}
        in_ch = 3
        n_mlp = 0
        self._local = None
        if with_local_feat == "ppf":
            self._local = f"SharedMLP_{n_mlp}"
            layers[self._local] = SharedMLP(4, [32, local_fuse_dim])
            n_mlp += 1
            in_ch += local_fuse_dim
        self._backbone: list[str] = []
        n_pv = 0
        for out_ch, num_blocks, resolution in blocks:
            out_ch = int(out_ch * width_multiplier)
            for _ in range(num_blocks):
                if resolution is None:
                    name = f"SharedMLP_{n_mlp}"
                    layers[name] = SharedMLP(in_ch, [out_ch])
                    n_mlp += 1
                else:
                    name = f"PVConv_{n_pv}"
                    layers[name] = PVConv(
                        in_ch, out_ch, point_kernel_formal=point_kernel_formal,
                        voxel_shape=voxel_shape,
                        resolution=int(resolution * voxel_resolution_multiplier),
                        with_coeff=with_coeff, with_se=with_se)
                    n_pv += 1
                self._backbone.append(name)
                in_ch = out_ch
        self.layers = nn.ModuleDict(layers)
        self.out_channels = in_ch

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        coords = inputs[..., :3]
        coords = coords - coords.mean(-2, keepdim=True)
        features = change_coords(coords, lrf_basis(coords, self.lrf_kind))
        if self._local is not None:
            if inputs.shape[-1] < 6:
                raise ValueError("local PPF features need normals: inputs [b, n, 6]")
            normals = inputs[..., 3:6]
            nbr, slot_ok = ball_query_group(coords, coords, torch.cat([coords, normals], -1),
                                            self.local_radius, self.local_neighbors)
            feats = local_ppf(nbr[..., :3], nbr[..., 3:], coords, normals)
            fused = self.layers[self._local](feats)
            fused = fused.masked_fill(~slot_ok[..., None], float("-inf"))
            features = torch.cat([features, fused.amax(-2)], dim=-1)
        for name in self._backbone:
            layer = self.layers[name]
            features = (layer(features, coords) if isinstance(layer, PVConv)
                        else layer(features))
        return features
