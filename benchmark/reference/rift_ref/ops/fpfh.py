"""Fast Point Feature Histograms (FPFH), twin of `rift_tpu/ops/fpfh.py`.

Per point, the SPFH is three soft 11-bin histograms of the Darboux-frame
angles (α, φ, θ) against its neighbours within `radius` among its k
nearest; FPFH(p) = SPFH(p) + (1/k_eff)·Σ_q SPFH(q)/‖p − q‖, each 11-bin
sub-histogram then scaled to an L1 norm of 100 (Open3D's convention): a
descriptor [..., n, 33].

The neighbour test is the reference's: d² < r² and d² > 1e-12, on the d²
that `ops/neighbors.py:knn` forms as ‖a‖² + ‖b‖² − 2a·b. A point's d² to
itself rounds to 0 or to about 1e-7 there, so some points count
themselves as a neighbour, at a weight of 1/√d² (~3e3). Which ones
depends on how the a·b product rounds, so the card and the CPU may decide
differently for the same cloud: `fpfh_from_knn` takes the neighbour list
as an argument, for a caller that wants both to see the same one.

The histograms are one-hot weighted sums over the k neighbours, as the
reference builds them: no float atomics, so two calls on the card agree
bit for bit. Nothing here needs a gradient: the inputs are data.
"""
from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from .lrf import _unit
from .neighbors import grouping, knn

Tensor = torch.Tensor

_BINS = 11


def _histogram(values: Tensor, lo: float, hi: float, mask: Tensor) -> Tensor:
    """Soft histogram of `values` [..., k] over the last axis, the masked
    entries left out -> [..., _BINS]: each value's weight is split linearly
    between the two nearest bin centres."""
    pos = torch.clamp((values - lo) / (hi - lo) * _BINS - 0.5, 0.0, _BINS - 1.0)
    lo_bin = torch.floor(pos)
    frac = pos - lo_bin
    lo_oh = F.one_hot(lo_bin.long(), _BINS).to(values.dtype)
    hi_oh = F.one_hot(torch.clamp(lo_bin + 1, max=_BINS - 1).long(), _BINS).to(values.dtype)
    onehot = lo_oh * (1.0 - frac[..., None]) + hi_oh * frac[..., None]
    onehot = torch.where(mask[..., None], onehot, torch.zeros_like(onehot))
    return onehot.sum(-2)


def _spfh(points: Tensor, normals: Tensor, idx: Tensor, mask: Tensor) -> Tensor:
    """The simplified PFH of each point [..., n, 33] over its neighbours
    `idx` [..., n, k] where `mask` holds."""
    d = grouping(points, idx) - points[..., :, None, :]
    du = _unit(d)
    nq = grouping(normals, idx)
    u = normals[..., :, None, :].expand(du.shape)
    v = _unit(torch.linalg.cross(du, u))
    w = torch.linalg.cross(u, v)
    alpha = (v * nq).sum(-1)
    phi = (u * du).sum(-1)
    theta = torch.atan2((w * nq).sum(-1), (u * nq).sum(-1))
    return torch.cat([_histogram(alpha, -1.0, 1.0, mask), _histogram(phi, -1.0, 1.0, mask),
                      _histogram(theta, -math.pi, math.pi, mask)], dim=-1)


def fpfh_from_knn(points: Tensor, normals: Tensor, d2: Tensor, idx: Tensor,
                  radius: float) -> Tensor:
    """FPFH [..., n, 33] of points and normals [..., n, 3] on the neighbour
    list of `knn` (squared distances `d2` and indices `idx`, [..., n, k])."""
    mask = (d2 < radius * radius) & (d2 > 1e-12)
    spfh = _spfh(points, normals, idx, mask)
    wgt = torch.where(mask, 1.0 / torch.sqrt(torch.clamp(d2, min=1e-12)), torch.zeros_like(d2))
    k_eff = torch.clamp(mask.sum(-1, keepdim=True).to(d2.dtype), min=1.0)
    out = spfh + (grouping(spfh, idx) * wgt[..., None]).sum(-2) / k_eff
    parts = out.split(_BINS, dim=-1)
    return torch.cat([100.0 * p / torch.clamp(p.sum(-1, keepdim=True), min=1e-12)
                      for p in parts], dim=-1)


def fpfh(points: Tensor, normals: Tensor, radius: float = 0.3,
         max_neighbors: int = 64) -> Tensor:
    """FPFH descriptors of points and normals [..., n, 3] -> [..., n, 33],
    over each point's `max_neighbors` nearest within `radius`."""
    d2, idx = knn(points, points, max_neighbors)
    return fpfh_from_knn(points, normals, d2, idx, radius)
