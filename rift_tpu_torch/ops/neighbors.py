"""Neighbour search: squared distances, k nearest neighbours, ball query,
grouping, the PointNet++ ball grouping and 3-NN interpolation, mutual NN
and its motion-gated form.

Twin of `rift_tpu/ops/neighbors.py`. The TPU shapes of that module (the
one-hot gathers and the [m, u, n] slot selector of `ball_query_group`,
64 GiB at flagship shapes) exist only to feed the MXU; here the same
neighbour sets come from `topk` over index keys and a row gather.

Layout: channels-last, points [..., n, 3], features [..., n, c].
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def pairwise_sqdist(a: Tensor, b: Tensor) -> Tensor:
    """Squared distances [..., n, m] between [..., n, c] and [..., m, c].

    Same expansion as the reference, ‖a‖² + ‖b‖² − 2·a·bᵀ, clamped at 0.
    """
    a2 = (a * a).sum(-1, keepdim=True)
    b2 = (b * b).sum(-1, keepdim=True)
    cross = torch.matmul(a, b.transpose(-1, -2))
    return torch.clamp(a2 + b2.transpose(-1, -2) - 2.0 * cross, min=0.0)


def knn(queries: Tensor, points: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """The k nearest of `points` [..., m, c] to each of `queries` [..., n, c]:
    (squared distances [..., n, k] ascending, indices int64 [..., n, k]),
    the lower index first on ties. With m < k the farthest neighbour
    repeats in the last slots."""
    d2 = pairwise_sqdist(queries, points)
    k_eff = min(k, points.shape[-2])
    dist, idx = torch.sort(d2, dim=-1, stable=True)
    dist, idx = dist[..., :k_eff], idx[..., :k_eff]
    if k_eff < k:
        pad = k - k_eff
        dist = torch.cat([dist, dist[..., -1:].expand(dist.shape[:-1] + (pad,))], -1)
        idx = torch.cat([idx, idx[..., -1:].expand(idx.shape[:-1] + (pad,))], -1)
    return dist, idx


def _first_valid(d2: Tensor, radius: float, u: int) -> tuple[Tensor, Tensor]:
    """First `u` in-radius indices in index order (self excluded by
    d² > 1e-5), `n` where a slot is empty; and the in-radius count."""
    n = d2.shape[-1]
    valid = (d2 < radius * radius) & (d2 > 1e-5)
    arange = torch.arange(n, device=d2.device, dtype=torch.int64)
    key = torch.where(valid, arange, torch.full_like(arange, n))
    u_eff = min(u, n)
    first_u = torch.topk(key, u_eff, dim=-1, largest=False, sorted=True).values
    if u_eff < u:  # fewer points than slots: pad with empties
        pad = torch.full(first_u.shape[:-1] + (u - u_eff,), n,
                         dtype=first_u.dtype, device=first_u.device)
        first_u = torch.cat([first_u, pad], dim=-1)
    return first_u, valid.sum(-1)


def ball_query(centers: Tensor, points: Tensor, radius: float,
               num_neighbors: int) -> Tensor:
    """Fixed-radius neighbour indices, int64 [..., m, u].

    The first u points with 1e-5 < d² < r², in index order; empty slots
    repeat the first-found neighbour; a center with no neighbour at all
    gets the nearest point (first index on ties) in every slot.
    """
    n = points.shape[-2]
    d2 = pairwise_sqdist(centers, points)
    first_u, cnt = _first_valid(d2, radius, num_neighbors)
    has = first_u < n
    padded = torch.where(has, first_u, first_u[..., :1].expand_as(first_u))
    nearest = torch.argmin(d2, dim=-1, keepdim=True)
    return torch.where((cnt > 0)[..., None], padded, nearest.expand_as(padded))


def gather_rows(x: Tensor, idx: Tensor) -> Tensor:
    """x [..., n, c], idx [..., k] -> x's rows idx [..., k, c]."""
    return torch.gather(x, -2, idx[..., None].expand(idx.shape + (x.shape[-1],)))


def grouping(features: Tensor, indices: Tensor) -> Tensor:
    """features [..., n, c], indices [..., m, u] -> [..., m, u, c]."""
    m, u = indices.shape[-2:]
    c = features.shape[-1]
    flat = indices.reshape(indices.shape[:-2] + (m * u, 1)).expand(
        indices.shape[:-2] + (m * u, c))
    return torch.gather(features, -2, flat).reshape(
        indices.shape[:-2] + (m, u, c))


def ball_query_group(centers: Tensor, points: Tensor, features: Tensor,
                     radius: float, num_neighbors: int
                     ) -> tuple[Tensor, Tensor]:
    """Eval grouping: (grouped [..., m, u, c], slot_valid bool [..., m, u]).

    The neighbour set of `ball_query`; slots past the in-radius count hold
    zero rows and `slot_valid` False, a center with no neighbour holds its
    nearest point in slot 0. Consumers mask with `slot_valid` before any
    reduction that is not duplicate-invariant.
    """
    n = points.shape[-2]
    u = num_neighbors
    d2 = pairwise_sqdist(centers, points)
    first_u, cnt = _first_valid(d2, radius, u)
    nearest = torch.argmin(d2, dim=-1, keepdim=True)
    idx = torch.where(first_u < n, first_u, torch.zeros_like(first_u))
    idx = torch.where((cnt > 0)[..., None], idx, nearest.expand_as(idx))
    slot = torch.arange(u, device=d2.device)
    slot_valid = slot < torch.clamp(cnt, min=1)[..., None]
    grouped = grouping(features, idx)
    return grouped * slot_valid[..., None].to(grouped.dtype), slot_valid


def ball_group(centers: Tensor, points: Tensor, features: Tensor | None, radius: float,
               num_neighbors: int, include_coordinates: bool = True) -> Tensor:
    """The PointNet++ grouping: `ball_query` of `centers` [..., m, 3] among
    `points` [..., n, 3], each neighbour's offset from its center
    [..., m, u, 3] (its coordinates without `include_coordinates`), then,
    when `features` [..., n, c] are given, the neighbours' features
    (after the offsets with `include_coordinates`, alone without)."""
    idx = ball_query(centers, points, radius, num_neighbors)
    nbr = grouping(points, idx)
    rel = nbr - centers[..., None, :]
    if features is None:
        return rel if include_coordinates else nbr
    feat = grouping(features, idx)
    return torch.cat([rel, feat], dim=-1) if include_coordinates else feat


def three_nn_interpolate(target_coords: Tensor, source_coords: Tensor,
                         source_features: Tensor) -> Tensor:
    """`source_features` [..., m, c] at `target_coords` [..., n, 3]: the
    mean of the 3 nearest of `source_coords` [..., m, 3], weighted by
    inverse squared distance (floored at 1e-10) -> [..., n, c]."""
    d2, idx = knn(target_coords, source_coords, 3)
    inv = 1.0 / torch.clamp(d2, min=1e-10)
    w = inv / inv.sum(-1, keepdim=True)
    return (w[..., None] * grouping(source_features, idx)).sum(-2)


def mutual_nearest_neighbors(feat1: Tensor, feat2: Tensor
                             ) -> tuple[Tensor, Tensor, Tensor]:
    """Cycle-consistent mutual nearest neighbours in feature space.

    feat1 [..., n1, c], feat2 [..., n2, c] -> (idx1 [n1], idx2 [..., n1],
    mask bool [..., n1]): idx2[i] is the NN of i in cloud 2 and mask[i]
    says the NN of idx2[i] in cloud 1 is i. Ties go to the first index.
    """
    d = pairwise_sqdist(feat1, feat2)
    corr12 = torch.argmin(d, dim=-1)
    corr21 = torch.argmin(d, dim=-2)
    n1 = feat1.shape[-2]
    arange = torch.arange(n1, device=feat1.device)
    mask = torch.gather(corr21, -1, corr12) == arange
    return arange, corr12, mask


def gated_mutual_nearest_neighbors(feat1: Tensor, feat2: Tensor, spatial_valid: Tensor
                                   ) -> tuple[Tensor, Tensor, Tensor]:
    """`mutual_nearest_neighbors` over the candidate pairs that
    `spatial_valid` [..., n1, n2] allows: the others are left out of both
    argmins (their distance set to the dtype's largest value), and a point
    with no allowed candidate comes back masked out."""
    big = torch.finfo(feat1.dtype).max
    d = pairwise_sqdist(feat1, feat2).masked_fill(~spatial_valid, big)
    corr12 = torch.argmin(d, dim=-1)
    corr21 = torch.argmin(d, dim=-2)
    n1 = feat1.shape[-2]
    arange = torch.arange(n1, device=feat1.device)
    has = torch.gather(spatial_valid, -1, corr12[..., None])[..., 0]
    mask = (torch.gather(corr21, -1, corr12) == arange) & has
    return arange, corr12, mask
