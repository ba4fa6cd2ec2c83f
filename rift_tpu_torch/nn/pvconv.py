"""PVConv and SE3d, twin of `rift_tpu/nn/pvconv.py` with the spherical
voxel grid and the `pointnet_kernel` point branch.

Voxel branch: spherical scatter-mean (K2) -> 2 × [Conv3d k=3 padding 1 +
BatchNorm (eps 1e-4) + LeakyReLU 0.1] -> SE3d -> spherical trilinear
devoxelize (K3; its backward is K4). Point branch: SharedMLP. Output
coefficient·voxel + point. BatchNorm has flax's semantics
(`nn/batch_norm.py`).
Features are channels-last [b, n, c] at the boundary; the grid is permuted
to [b, c, r, r, r] around the convolutions, with axes (γ, α, β).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.spherical import spherical_avg_voxelize, spherical_trilinear_devoxelize
from .batch_norm import BatchNorm
from .shared_mlp import SharedMLP


class SE3d(nn.Module):
    """Squeeze-excitation over a channels-first grid [b, c, r, r, r]."""

    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        self.fc1 = nn.Linear(channels, max(channels // reduction, 1), bias=False)
        self.fc2 = nn.Linear(max(channels // reduction, 1), channels, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        squeezed = x.mean(dim=(-3, -2, -1))
        gate = torch.sigmoid(self.fc2(torch.relu(self.fc1(squeezed))))
        return x * gate[..., None, None, None]


class PVConv(nn.Module):
    """One point-voxel block: forward(features [b, n, c], coords [b, n, 3])
    -> [b, n, out]. `coords` are raw; each block voxelizes them anew."""

    def __init__(self, in_channels: int, out_channels: int,
                 point_kernel_formal: str = "pointnet_kernel",
                 voxel_shape: str = "spherical", resolution: int = 32,
                 kernel_size: int = 3, with_coeff: bool = True, with_se: bool = True):
        super().__init__()
        if point_kernel_formal != "pointnet_kernel":
            raise NotImplementedError(f"point kernel {point_kernel_formal!r} is not ported yet")
        if voxel_shape != "spherical":
            raise NotImplementedError(f"voxel shape {voxel_shape!r} is not ported yet")
        self.resolution = resolution
        self.convs = nn.ModuleList([
            nn.Conv3d(c_in, out_channels, kernel_size, padding=kernel_size // 2)
            for c_in in (in_channels, out_channels)])
        self.bns = nn.ModuleList([BatchNorm(out_channels, eps=1e-4) for _ in range(2)])
        self.se = SE3d(out_channels) if with_se else None
        self.point = SharedMLP(in_channels, [out_channels])
        self.coefficient = nn.Parameter(torch.ones(())) if with_coeff else None

    def forward(self, features: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        r = self.resolution
        grid, inds, norm_coords = spherical_avg_voxelize(features, coords, r)
        v = grid.permute(0, 4, 1, 2, 3)  # [b, c, γ, α, β]
        for conv, bn in zip(self.convs, self.bns):
            v = F.leaky_relu(bn(conv(v)), negative_slope=0.1)
        if self.se is not None:
            v = self.se(v)
        v = v.permute(0, 2, 3, 4, 1).contiguous()
        voxel_features = spherical_trilinear_devoxelize(v, norm_coords, inds, r)
        point_features = self.point(features)
        if self.coefficient is not None:
            return self.coefficient * voxel_features + point_features
        return voxel_features + point_features
