"""Spherical voxelization (scatter-mean) and spherical trilinear
devoxelization, twin of `rift_tpu/ops/spherical.py`.

Binning: γ = ‖p‖ after centering and scaling so the farthest point has
γ = 1; a point is undefined (index −1) when γ == 0 or γ >= 1 − 1e-6 (the
margin keeps the farthest point undefined whatever the rounding of the
scale); β = acos(z/γ); α = atan(y/x) + π(1 − sign x)/2 with the x == 0
cases, shifted by π/r and wrapped into [0, 2π). Grid axes are (γ, α, β),
flat index gγ·r² + gα·r + gβ. The scatter-mean is K2 and the 8-corner
gather K3 (`ops/cuda/onehot_ops.py`).

Gradients, twins of the custom VJPs of
`rift_tpu/ops/pallas/spherical_fast.py`, come from `ops/voxel_autograd.py`
(shared with the cube grid): the scatter-mean's backward is a row gather,
the corner gather's backward for the grid is K4. Coordinates, and so the
voxel indices and corner weights, get no gradient.
"""
from __future__ import annotations

import math

import torch

from .voxel_autograd import CornerGather, ScatterMean

Tensor = torch.Tensor


def normalize_coords_sphere(coords: Tensor) -> Tensor:
    """Center by centroid and scale so the max radius is 1; [b, n, 3]."""
    centered = coords - coords.mean(-2, keepdim=True)
    max_norm = torch.linalg.vector_norm(centered, dim=-1, keepdim=True).amax(-2, keepdim=True)
    return centered / (max_norm + 1e-20)


def spherical_coords(norm_coords: Tensor, resolution: int
                     ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """(γ, α, β, defined-mask) from normalized coords."""
    r = resolution
    x, y, z = norm_coords[..., 0], norm_coords[..., 1], norm_coords[..., 2]
    gamma = torch.sqrt(x * x + y * y + z * z)
    defined = (gamma > 0.0) & (gamma < 1.0 - 1e-6)
    safe_gamma = torch.clamp(gamma, min=1e-20)
    beta = torch.arccos(torch.clamp(z / safe_gamma, -1.0, 1.0))
    defined = defined & (beta < math.pi)
    x_zero = x == 0.0
    base = (torch.arctan(y / torch.where(x_zero, torch.ones_like(x), x))
            + math.pi * (1.0 - torch.sign(x)) / 2.0)
    on_axis = torch.where(y != 0.0, torch.sign(y) * math.pi * 0.5, torch.zeros_like(y))
    alpha = torch.where(x_zero, on_axis, base)
    alpha = alpha + math.pi / r
    alpha = torch.where(alpha < 0.0, alpha + 2.0 * math.pi, alpha)
    return gamma, alpha, beta, defined


def spherical_voxel_indices(norm_coords: Tensor, resolution: int
                            ) -> tuple[Tensor, Tensor]:
    """Flat voxel index per point (int64 [b, n], −1 when undefined) and the
    defined mask."""
    r = resolution
    gamma, alpha, beta, defined = spherical_coords(norm_coords, r)
    gx = torch.clamp(torch.floor(gamma * r).long(), 0, r - 1)
    gy = torch.clamp(torch.floor(alpha * r / (2.0 * math.pi)).long(), 0, r - 1)
    gz = torch.clamp(torch.floor(beta * r / math.pi).long(), 0, r - 1)
    ind = gx * (r * r) + gy * r + gz
    return torch.where(defined, ind, torch.full_like(ind, -1)), defined


def spherical_avg_voxelize(features: Tensor, coords: Tensor, resolution: int
                           ) -> tuple[Tensor, Tensor, Tensor]:
    """features [b, n, c], raw coords [b, n, 3] -> (grid [b, r, r, r, c] with
    axes (γ, α, β), indices [b, n] (−1 = undefined), normalized coords).
    bf16 features are summed in f32 and the grid is f32, as the Pallas K2
    writes it."""
    r = resolution
    norm_coords = normalize_coords_sphere(coords.detach())
    inds, _ = spherical_voxel_indices(norm_coords, r)
    flat, _ = ScatterMean.apply(features, inds, r * r * r)
    grid = flat.reshape(flat.shape[:-2] + (r, r, r, flat.shape[-1]))
    return grid, inds, norm_coords


def spherical_corner_weights(norm_coords: Tensor, point_inds: Tensor,
                             resolution: int) -> tuple[Tensor, Tensor]:
    """8 corner flat indices (int64 [..., n, 8], −1 rows for undefined
    points) and trilinear weights [..., n, 8]; γ and β clamp at the
    boundary shells, α wraps."""
    r = resolution
    gamma, alpha, beta, _ = spherical_coords(norm_coords, r)
    u = torch.stack([gamma * r, alpha * r / (2.0 * math.pi), beta * r / math.pi], dim=-1)
    u = torch.clamp(u, 0.0, float(r) - 1e-6)
    lo = torch.floor(u)
    frac = u - lo
    lo_i = torch.clamp(lo.long(), 0, r - 1)
    hi_g = torch.clamp(lo_i[..., 0] + 1, max=r - 1)
    hi_a = torch.remainder(lo_i[..., 1] + 1, r)
    hi_b = torch.clamp(lo_i[..., 2] + 1, max=r - 1)
    idxs, ws = [], []
    for dg in (0, 1):
        wg = frac[..., 0] if dg else (1.0 - frac[..., 0])
        ig = hi_g if dg else lo_i[..., 0]
        for da in (0, 1):
            wa = frac[..., 1] if da else (1.0 - frac[..., 1])
            ia = hi_a if da else lo_i[..., 1]
            for db in (0, 1):
                wb = frac[..., 2] if db else (1.0 - frac[..., 2])
                ib = hi_b if db else lo_i[..., 2]
                idxs.append(ig * (r * r) + ia * r + ib)
                ws.append(wg * wa * wb)
    idx = torch.stack(idxs, dim=-1)
    w = torch.stack(ws, dim=-1)
    defined = (point_inds >= 0)[..., None]
    return (torch.where(defined, idx, torch.full_like(idx, -1)),
            torch.where(defined, w, torch.zeros_like(w)))


def spherical_trilinear_devoxelize(voxel_grid: Tensor, norm_coords: Tensor,
                                   point_inds: Tensor, resolution: int) -> Tensor:
    """Trilinear interpolation of grid [b, r, r, r, c] at each point, in
    (γ, α, β) grid units -> [b, n, c]; undefined points give 0. A bf16 grid
    is read as it is and the result is f32."""
    r = resolution
    c = voxel_grid.shape[-1]
    flat = voxel_grid.reshape(voxel_grid.shape[:-4] + (r * r * r, c))
    idx, w = spherical_corner_weights(norm_coords.detach(), point_inds, r)
    return CornerGather.apply(flat, idx, w)
