"""PointNet++ modules, twins of `rift_tpu/nn/pointnet2.py`: global
abstraction (`PointNetAModule`), set abstraction (`PointNetSAModule`) and
feature propagation (`PointNetFPModule`), channels-last. Each holds its
SharedMLPs under their flax names in `layers`, so `weights.from_flax`
maps the module's own flax tree by name."""
from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from ..ops.neighbors import ball_group, three_nn_interpolate
from ..ops.sampling import furthest_point_sample, gather
from .shared_mlp import SharedMLP


class PointNetAModule(nn.Module):
    """forward(features [b, n, in_channels], coords [b, n, 3]) -> [b, mlp[-1]]:
    SharedMLP on every point ([coords, features] with
    `include_coordinates`), then the max over the points."""

    def __init__(self, in_channels: int, mlp: Sequence[int], include_coordinates: bool = True):
        super().__init__()
        self.include_coordinates = include_coordinates
        width = in_channels + 3 if include_coordinates else in_channels
        self.layers = nn.ModuleDict({"SharedMLP_0": SharedMLP(width, list(mlp))})

    def forward(self, features: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        x = torch.cat([coords, features], -1) if self.include_coordinates else features
        return self.layers["SharedMLP_0"](x).amax(-2)


class PointNetSAModule(nn.Module):
    """forward(features [b, n, in_channels], coords [b, n, 3]) ->
    (features [b, num_centers, Σ mlp[-1]], centers [b, num_centers, 3]):
    `num_centers` furthest-point samples as centers; per (radius, k, mlp)
    branch, `ball_group` of each center's k neighbours (offsets then
    features with `include_coordinates`), its SharedMLP and the max over
    the neighbours; the branches concatenated."""

    def __init__(self, in_channels: int, num_centers: int, radii: Sequence[float],
                 num_neighbors: Sequence[int], mlps: Sequence[Sequence[int]],
                 include_coordinates: bool = True):
        super().__init__()
        if not len(radii) == len(num_neighbors) == len(mlps):
            raise ValueError("radii, num_neighbors and mlps need one entry per branch")
        self.num_centers = num_centers
        self.radii = tuple(radii)
        self.num_neighbors = tuple(num_neighbors)
        self.include_coordinates = include_coordinates
        width = in_channels + 3 if include_coordinates else in_channels
        self.layers = nn.ModuleDict({f"SharedMLP_{i}": SharedMLP(width, list(mlp))
                                     for i, mlp in enumerate(mlps)})

    def forward(self, features: torch.Tensor, coords: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        centers = gather(coords, furthest_point_sample(coords, self.num_centers))
        outs = []
        for i, (radius, k) in enumerate(zip(self.radii, self.num_neighbors)):
            grouped = ball_group(centers, coords, features, radius, k,
                                 include_coordinates=self.include_coordinates)
            outs.append(self.layers[f"SharedMLP_{i}"](grouped).amax(-2))
        return torch.cat(outs, -1), centers


class PointNetFPModule(nn.Module):
    """forward(dense_coords [b, n, 3], coarse_coords [b, m, 3],
    coarse_features [b, m, in_channels], dense_features [b, n, skip] or
    None) -> [b, n, mlp[-1]]: the coarse features at the dense points
    (`three_nn_interpolate`), the skip features after them, SharedMLP."""

    def __init__(self, in_channels: int, mlp: Sequence[int]):
        super().__init__()
        self.layers = nn.ModuleDict({"SharedMLP_0": SharedMLP(in_channels, list(mlp))})

    def forward(self, dense_coords: torch.Tensor, coarse_coords: torch.Tensor,
                coarse_features: torch.Tensor,
                dense_features: torch.Tensor | None = None) -> torch.Tensor:
        x = three_nn_interpolate(dense_coords, coarse_coords, coarse_features)
        if dense_features is not None:
            x = torch.cat([x, dense_features], -1)
        return self.layers["SharedMLP_0"](x)
