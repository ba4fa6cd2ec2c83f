"""Cube voxelization (scatter-mean) and trilinear devoxelization, twin of
`rift_tpu/ops/voxelize.py` (`scatter_mean`, `normalize_coords_cube`,
`cube_voxel_indices`, `avg_voxelize`, `trilinear_devoxelize`).

Grids are channels-last [b, r, r, r, c] with axes (x, y, z), flat index
x·r² + y·r + z. Every point falls in a cell (coordinates are clamped to
[0, r − 1]), so no index is −1, unlike the spherical grid. The
scatter-mean is K2 and the 8-corner gather K3, through the autograd
Functions the spherical grid uses (`ops/voxel_autograd.py`): the
scatter-mean's backward is a row gather, the gather's backward K4.
Coordinates, and so indices and corner weights, take no gradient.

The reference's factored selectors (`cube_weight_planes`,
`avg_voxelize_fast`, `trilinear_devoxelize_fast`) are the TPU's shape of
the same function and have no twin here.
"""
from __future__ import annotations

import torch

from .voxel_autograd import CornerGather, ScatterMean

Tensor = torch.Tensor


def scatter_mean(features: Tensor, indices: Tensor, num_segments: int,
                 valid: Tensor | None = None) -> Tensor:
    """The mean of the features [b, n, c] of each of `num_segments` slots
    -> [b, num_segments, c] (0 where a slot is empty): K2 forward, its row
    gather backward (`ScatterMean`). Points where `valid` [b, n] is False,
    or whose index is outside [0, num_segments), are dropped. bf16
    features are summed in f32 and the result is f32."""
    if valid is not None:
        indices = torch.where(valid, indices, torch.full_like(indices, -1))
    return ScatterMean.apply(features, indices, num_segments)[0]


def normalize_coords_cube(coords: Tensor, resolution: int, normalize: bool = True,
                          eps: float = 0.0) -> Tensor:
    """Centre by the mean; with `normalize`, divide by 2·(largest radius) +
    eps and shift by 0.5, else map [−1, 1] to [0, 1] by (c + 1)/2; scale by
    r and clamp to [0, r − 1]. [b, n, 3] -> continuous grid coords."""
    r = resolution
    centred = coords - coords.mean(-2, keepdim=True)
    if normalize:
        max_norm = torch.linalg.vector_norm(centred, dim=-1, keepdim=True).amax(-2, keepdim=True)
        norm = centred / (max_norm * 2.0 + eps) + 0.5
    else:
        norm = (centred + 1.0) / 2.0
    return torch.clamp(norm * r, 0.0, r - 1.0)


def cube_voxel_indices(grid_coords: Tensor, resolution: int) -> Tensor:
    """Round (half to even, as `jnp.round`) and clamp the grid coords:
    [b, n, 3] -> flat int64 indices [b, n] in [0, r³)."""
    r = resolution
    v = torch.clamp(torch.round(grid_coords).long(), 0, r - 1)
    return v[..., 0] * (r * r) + v[..., 1] * r + v[..., 2]


def avg_voxelize(features: Tensor, coords: Tensor, resolution: int, normalize: bool = True,
                 eps: float = 0.0) -> tuple[Tensor, Tensor, Tensor]:
    """features [b, n, c], raw coords [b, n, 3] -> (grid [b, r, r, r, c],
    indices [b, n], grid coords [b, n, 3]). bf16 features are summed in
    f32 and the grid is f32, as on the spherical grid."""
    r = resolution
    grid_coords = normalize_coords_cube(coords.detach(), r, normalize=normalize, eps=eps)
    inds = cube_voxel_indices(grid_coords, r)
    flat, _ = ScatterMean.apply(features, inds, r * r * r)
    grid = flat.reshape(flat.shape[:-2] + (r, r, r, flat.shape[-1]))
    return grid, inds, grid_coords


def cube_corner_weights(grid_coords: Tensor, resolution: int) -> tuple[Tensor, Tensor]:
    """The 8 corners of each point's cell, flat int64 [..., n, 8], and their
    trilinear weights wx·wy·wz [..., n, 8], in the reference's order (dx,
    dy, dz, each 0 then 1). The upper corner of an axis is lo + 1 only
    where the fraction is > 0, and never past r − 1: at r − 1 the
    fraction is 0 and hi == lo."""
    r = resolution
    lo = torch.floor(grid_coords)
    frac = grid_coords - lo
    lo_i = lo.long()
    hi_i = torch.clamp(lo_i + (frac > 0).long(), max=r - 1)
    idxs, ws = [], []
    for dx in (0, 1):
        wx = frac[..., 0] if dx else (1.0 - frac[..., 0])
        ix = hi_i[..., 0] if dx else lo_i[..., 0]
        for dy in (0, 1):
            wy = frac[..., 1] if dy else (1.0 - frac[..., 1])
            iy = hi_i[..., 1] if dy else lo_i[..., 1]
            for dz in (0, 1):
                wz = frac[..., 2] if dz else (1.0 - frac[..., 2])
                iz = hi_i[..., 2] if dz else lo_i[..., 2]
                idxs.append(ix * (r * r) + iy * r + iz)
                ws.append(wx * wy * wz)
    return torch.stack(idxs, dim=-1), torch.stack(ws, dim=-1)


def trilinear_devoxelize(voxel_grid: Tensor, grid_coords: Tensor, resolution: int) -> Tensor:
    """Trilinear interpolation of grid [b, r, r, r, c] at continuous grid
    coords [b, n, 3] in [0, r − 1] -> [b, n, c], the corners summed in
    order (K3). A bf16 grid is read as it is and the result is f32."""
    r = resolution
    c = voxel_grid.shape[-1]
    flat = voxel_grid.reshape(voxel_grid.shape[:-4] + (r * r * r, c))
    idx, w = cube_corner_weights(grid_coords.detach(), r)
    return CornerGather.apply(flat, idx, w)
