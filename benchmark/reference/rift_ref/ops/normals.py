"""Surface normal estimation (hybrid-radius PCA), twin of
`rift_tpu/ops/normals.py:estimate_normals`.

All points within `radius` contribute to the plane fit, and a query's
radius grows to its `min_neighbors`-th nearest distance when fewer fall
inside. The k-th distance must be exact: an approximate one inflates
sparse neighbourhoods, the covariance turns near-isotropic and the normal
loses rotation equivariance (`rift_tpu/ops/normals.py:130-140`). The
moments come from K1 (`ops/cuda/normals_kernel.py`); the covariance,
eigenvector and camera flip are the component-wise epilogue of the
reference's fused path.
"""
from __future__ import annotations

import torch

from .plain.normals_kernel import neighborhood_moments
from .eig3 import smallest_eigenvector_sym3_components

Tensor = torch.Tensor


def estimate_normals(points: Tensor, radius: float = 0.1, max_neighbors: int | None = None,
                     camera: Tensor | None = None, min_neighbors: int = 16) -> Tensor:
    """Per-point unit normals oriented towards the camera: points
    [..., n, 3] -> normals [..., n, 3], each flipped so that
    n·(camera − p) >= 0. `camera` is a [3] tensor, None for the origin.
    `max_neighbors` is accepted and ignored, as in the reference (the
    moments have no cap)."""
    del max_neighbors
    shape = points.shape
    n = shape[-2]
    use_k = bool(min_neighbors and min_neighbors > 1 and n > min_neighbors)
    k = min(min_neighbors, n) if use_k else 0
    pts = points.reshape((-1,) + tuple(shape[-2:])).to(torch.float32)
    s1, s2, cnt = neighborhood_moments(pts, k, float(radius * radius))
    inv = 1.0 / torch.clamp(cnt, min=1.0)
    mux, muy, muz = s1[..., 0] * inv, s1[..., 1] * inv, s1[..., 2] * inv
    c00 = s2[..., 0, 0] * inv - mux * mux
    c01 = s2[..., 0, 1] * inv - mux * muy
    c02 = s2[..., 0, 2] * inv - mux * muz
    c11 = s2[..., 1, 1] * inv - muy * muy
    c12 = s2[..., 1, 2] * inv - muy * muz
    c22 = s2[..., 2, 2] * inv - muz * muz
    # Degenerate neighbourhoods (< 3 points): identity covariance -> a
    # finite, arbitrary normal.
    deg = cnt < 3
    one, zero = torch.ones_like(c00), torch.zeros_like(c00)
    c00, c11, c22 = (torch.where(deg, one, c) for c in (c00, c11, c22))
    c01, c02, c12 = (torch.where(deg, zero, c) for c in (c01, c02, c12))
    vx, vy, vz = smallest_eigenvector_sym3_components(c00, c01, c02, c11, c12, c22)
    if camera is None:
        dot = -(vx * pts[..., 0] + vy * pts[..., 1] + vz * pts[..., 2])  # n · (0 − p)
    else:
        cam = torch.as_tensor(camera, dtype=torch.float32, device=pts.device)
        dot = (vx * (cam[0] - pts[..., 0]) + vy * (cam[1] - pts[..., 1])
               + vz * (cam[2] - pts[..., 2]))  # n · (camera − p)
    sign = torch.where(dot < 0.0, -one, one)
    inv_n = sign / torch.clamp(torch.sqrt(vx * vx + vy * vy + vz * vz), min=1e-12)
    normal = torch.stack([vx * inv_n, vy * inv_n, vz * inv_n], dim=-1)
    return normal.reshape(shape).to(points.dtype)
