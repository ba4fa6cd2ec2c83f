"""PVConv and SE3d, twin of `rift_tpu/nn/pvconv.py` with both voxel grids
and both point branches.

Voxel branch: scatter-mean (K2) into the spherical or the cube grid -> 2 ×
[Conv3d k=3 padding 1 + BatchNorm (eps 1e-4) + LeakyReLU 0.1] -> SE3d ->
the grid's trilinear devoxelize (K3; its backward is K4). The cube grid
takes `normalize` and `eps` as the reference's block does (the model
passes `normalize=False`). Point branch: `pointnet_kernel` is a SharedMLP
on the features; `dgcnn_kernel` is a SharedMLP(2·c_in) on [features − the
mean of the point's own voxel, features], with an edge of 0 for undefined
(spherical) points. Output coefficient·voxel + point. BatchNorm has flax's
semantics (`nn/batch_norm.py`).

Features are channels-last [b, n, c] at the boundary. In f32 the grid is
permuted to [b, c, r, r, r] around the convolutions (cuDNN), with axes
(γ, α, β) or (x, y, z). With `dtype=torch.bfloat16` the block computes as the
reference's `PVConv(dtype=bfloat16)`: features are cast to bf16 at the
entry, K2 sums them in f32, the grid is cast to bf16 for the convolutions,
and the voxel branch stays channels-last and bf16 up to the devoxelize,
which reads the bf16 grid and writes f32; the f32 coefficient promotes the
block's output to f32. In eval mode the bf16 convolutions are K5
(`ops/cuda/conv3d.py`), in training cuDNN; each adds its bias in bf16 to
the rounded output, as flax's `nn.Conv(dtype=bfloat16)` does.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.plain.conv3d import conv3d_same, padded_bf16
from ..ops.spherical import spherical_avg_voxelize, spherical_trilinear_devoxelize
from ..ops.voxelize import avg_voxelize, trilinear_devoxelize
from .batch_norm import BatchNorm
from .shared_mlp import SharedMLP, dense

POINT_KERNELS = ("pointnet_kernel", "dgcnn_kernel")
VOXEL_SHAPES = ("spherical", "cube")


def _leaky_relu(x: torch.Tensor) -> torch.Tensor:
    # The slope rounded to x's type first, as JAX multiplies by a weakly
    # typed 0.1.
    return F.leaky_relu(x, negative_slope=float(torch.tensor(0.1, dtype=x.dtype)))


class SE3d(nn.Module):
    """Squeeze-excitation over a grid, channels-first [b, c, r, r, r] or,
    with `channels_last`, [b, r, r, r, c]; its two Dense layers compute in
    `dtype` when one is given."""

    def __init__(self, channels: int, reduction: int = 8, dtype: torch.dtype | None = None):
        super().__init__()
        self.fc1 = nn.Linear(channels, max(channels // reduction, 1), bias=False)
        self.fc2 = nn.Linear(max(channels // reduction, 1), channels, bias=False)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, channels_last: bool = False) -> torch.Tensor:
        squeezed = x.mean(dim=(1, 2, 3) if channels_last else (-3, -2, -1))
        h = torch.relu(dense(self.fc1, squeezed, self.dtype))
        gate = torch.sigmoid(dense(self.fc2, h, self.dtype))
        return x * (gate[:, None, None, None, :] if channels_last
                    else gate[..., None, None, None])


class PVConv(nn.Module):
    """One point-voxel block: forward(features [b, n, c], coords [b, n, 3])
    -> [b, n, out]. `coords` are raw; each block voxelizes them anew."""

    def __init__(self, in_channels: int, out_channels: int,
                 point_kernel_formal: str = "dgcnn_kernel",
                 voxel_shape: str = "spherical", resolution: int = 32,
                 kernel_size: int = 3, with_coeff: bool = False, with_se: bool = False,
                 normalize: bool = True, eps: float = 0.0,
                 dtype: torch.dtype | None = None):
        super().__init__()
        if point_kernel_formal not in POINT_KERNELS:
            raise ValueError(f"unknown point kernel {point_kernel_formal!r}")
        if voxel_shape not in VOXEL_SHAPES:
            raise ValueError(f"unknown voxel shape {voxel_shape!r}")
        if dtype not in (None, torch.bfloat16):
            raise ValueError(f"PVConv computes in f32 or bf16, not {dtype}")
        if dtype is not None and kernel_size != 3:
            raise NotImplementedError("the bf16 voxel branch takes 3x3x3 convolutions")
        self.resolution = resolution
        self.cube = voxel_shape == "cube"
        self.normalize = normalize
        self.eps = eps
        self.dtype = dtype
        self.dgcnn = point_kernel_formal == "dgcnn_kernel"
        self.convs = nn.ModuleList([
            nn.Conv3d(c_in, out_channels, kernel_size, padding=kernel_size // 2)
            for c_in in (in_channels, out_channels)])
        self.bns = nn.ModuleList([BatchNorm(out_channels, eps=1e-4) for _ in range(2)])
        self.se = SE3d(out_channels, dtype=dtype) if with_se else None
        self.point = SharedMLP(2 * in_channels if self.dgcnn else in_channels, [out_channels],
                               dtype=dtype)
        self.coefficient = nn.Parameter(torch.ones(())) if with_coeff else None

    def forward(self, features: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        r = self.resolution
        if self.dtype is not None:
            features = features.to(self.dtype)
        if self.cube:
            grid, inds, grid_coords = avg_voxelize(features, coords, r, self.normalize, self.eps)
        else:
            grid, inds, norm_coords = spherical_avg_voxelize(features, coords, r)
        v = self._voxel_branch(grid) if self.dtype is None else self._voxel_branch_low(grid)
        if self.cube:
            voxel_features = trilinear_devoxelize(v, grid_coords, r)
        else:
            voxel_features = spherical_trilinear_devoxelize(v, norm_coords, inds, r)
        point_in = features
        if self.dgcnn:
            b, n, c = features.shape
            undefined = inds < 0  # spherical points off the grid get an edge of 0 (cube: none)
            safe = torch.where(undefined, torch.zeros_like(inds), inds)
            # The mean of the point's own voxel, in the features' type.
            center = torch.gather(grid.reshape(b, r * r * r, c), 1,
                                  safe[..., None].expand(b, n, c)).to(features.dtype)
            edge = torch.where(undefined[..., None], torch.zeros_like(features),
                               features - center)
            point_in = torch.cat([edge, features], dim=-1)
        point_features = self.point(point_in)
        if self.coefficient is not None:
            return self.coefficient * voxel_features + point_features
        return voxel_features + point_features

    def _voxel_branch(self, grid: torch.Tensor) -> torch.Tensor:
        """f32: cuDNN on the channels-first grid; returns [b, r, r, r, out]."""
        v = grid.permute(0, 4, 1, 2, 3)  # [b, c, γ, α, β]
        for conv, bn in zip(self.convs, self.bns):
            v = _leaky_relu(bn(conv(v)))
        if self.se is not None:
            v = self.se(v)
        return v.permute(0, 2, 3, 4, 1).contiguous()

    def _voxel_branch_low(self, grid: torch.Tensor) -> torch.Tensor:
        """`dtype`: channels-last throughout, K5 in eval and cuDNN in
        training; returns [b, r, r, r, out] in `dtype`. In eval the cast to
        bf16 writes the layout K5 loads by TMA (`padded_bf16`)."""
        eval_bf16 = not self.training and self.dtype == torch.bfloat16
        v = padded_bf16(grid) if eval_bf16 else grid.to(self.dtype)
        for conv, bn in zip(self.convs, self.bns):
            w = conv.weight.to(self.dtype)
            if self.training:
                y = F.conv3d(v.permute(0, 4, 1, 2, 3), w, padding=1).permute(0, 2, 3, 4, 1)
            else:
                y = conv3d_same(v, w)
            y = y + conv.bias.to(self.dtype)
            v = _leaky_relu(bn(y.reshape(-1, y.shape[-1])).reshape(y.shape))
        if self.se is not None:
            v = self.se(v, channels_last=True)
        return v.contiguous()
