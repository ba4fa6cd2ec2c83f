"""Closed-form eigen-analysis of batched symmetric 3×3 matrices.

Twin of `rift_tpu/ops/eig3.py` (Smith 1961): eigenvalues from the
characteristic polynomial, eigenvectors from the largest cross product of
two rows of (A − λI). `torch.linalg.eigh` is not used: the Kabsch solver
(`registration/kabsch.py`) depends on these vector conventions — signs,
the +z fallback and the right-handed completion.
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def unit_axis(k: int, like: Tensor) -> Tensor:
    """The unit vector along axis k in `like`'s type and device, made on the
    device (a `torch.tensor` of constants would be a synchronous copy from
    the host on the card)."""
    return torch.eye(3, dtype=like.dtype, device=like.device)[k]


def _det3(b: Tensor) -> Tensor:
    return (b[..., 0, 0] * (b[..., 1, 1] * b[..., 2, 2] - b[..., 1, 2] * b[..., 2, 1])
            - b[..., 0, 1] * (b[..., 1, 0] * b[..., 2, 2] - b[..., 1, 2] * b[..., 2, 0])
            + b[..., 0, 2] * (b[..., 1, 0] * b[..., 2, 1] - b[..., 1, 1] * b[..., 2, 0]))


def eigvals_sym3(a: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Eigenvalues of symmetric [..., 3, 3], ascending (λ0 <= λ1 <= λ2)."""
    q = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1) / 3.0
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    b = a - q[..., None, None] * eye
    p2 = (b * b).sum((-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    r = torch.clamp(_det3(b) / (2.0 * p**3), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam2 = q + 2.0 * p * torch.cos(phi)
    lam0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam1 = 3.0 * q - lam0 - lam2
    return lam0, lam1, lam2


def _eigvec_for(a: Tensor, lam: Tensor) -> Tensor:
    """Unit eigenvector of symmetric [..., 3, 3] for eigenvalue lam [...]."""
    c = a - lam[..., None, None] * torch.eye(3, dtype=a.dtype, device=a.device)
    r0, r1, r2 = c[..., 0, :], c[..., 1, :], c[..., 2, :]
    crosses = torch.stack([torch.linalg.cross(r0, r1), torch.linalg.cross(r0, r2),
                           torch.linalg.cross(r1, r2)], dim=-2)  # [..., 3, 3]
    norms = (crosses * crosses).sum(-1)
    best = torch.argmax(norms, dim=-1)  # first index on ties, as jnp.argmax
    vec = torch.gather(crosses, -2, best[..., None, None].expand(
        best.shape + (1, 3)))[..., 0, :]
    norm = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    fallback = unit_axis(2, a).expand(vec.shape)
    ok = norm[..., 0] > 1e-20
    return torch.where(ok[..., None], vec / torch.clamp(norm, min=1e-20), fallback)


def smallest_eigenvector_sym3(a: Tensor) -> Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric [..., 3, 3]."""
    lam0, _, _ = eigvals_sym3(a)
    return _eigvec_for(a, lam0)


def _unit(v: Tensor) -> Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-20)


def eigh_sym3(a: Tensor) -> tuple[Tensor, Tensor]:
    """(eigenvalues ascending [..., 3], eigenvectors as columns [..., 3, 3])."""
    lam0, lam1, lam2 = eigvals_sym3(a)
    v0 = _eigvec_for(a, lam0)
    v2 = _eigvec_for(a, lam2)
    # Re-orthogonalize v0 against v2 (the best-separated pair).
    v0 = v0 - (v0 * v2).sum(-1, keepdim=True) * v2
    n0 = torch.linalg.vector_norm(v0, dim=-1, keepdim=True)
    alt = torch.linalg.cross(v2, unit_axis(0, a).expand(v2.shape))
    alt2 = torch.linalg.cross(v2, unit_axis(1, a).expand(v2.shape))
    alt = torch.where(torch.linalg.vector_norm(alt, dim=-1, keepdim=True) > 0.1,
                      alt, alt2)
    alt = _unit(alt)
    v0 = torch.where(n0 > 1e-6, v0 / torch.clamp(n0, min=1e-20), alt)
    v1 = _unit(torch.linalg.cross(v2, v0))  # right-handed middle vector
    vals = torch.stack([lam0, lam1, lam2], dim=-1)
    vecs = torch.stack([v0, v1, v2], dim=-1)  # columns
    return vals, vecs


def smallest_eigenvector_sym3_components(a00, a01, a02, a11, a12, a22):
    """Unit eigenvector of the smallest eigenvalue of the symmetric matrix
    [[a00,a01,a02],[a01,a11,a12],[a02,a12,a22]] given as six [...] tensors
    -> (vx, vy, vz). Same closed form as `smallest_eigenvector_sym3`."""
    third = 1.0 / 3.0
    q = (a00 + a11 + a22) * third
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    det_b = (b00 * (b11 * b22 - a12 * a12)
             - a01 * (a01 * b22 - a12 * a02)
             + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(det_b / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) * third
    lam0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi * third)

    r0x, r0y, r0z = a00 - lam0, a01, a02
    r1x, r1y, r1z = a01, a11 - lam0, a12
    r2x, r2y, r2z = a02, a12, a22 - lam0

    def cross(ax, ay, az, bx, by, bz):
        return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)

    c01 = cross(r0x, r0y, r0z, r1x, r1y, r1z)
    c02 = cross(r0x, r0y, r0z, r2x, r2y, r2z)
    c12 = cross(r1x, r1y, r1z, r2x, r2y, r2z)
    n01 = c01[0] ** 2 + c01[1] ** 2 + c01[2] ** 2
    n02 = c02[0] ** 2 + c02[1] ** 2 + c02[2] ** 2
    n12 = c12[0] ** 2 + c12[1] ** 2 + c12[2] ** 2
    # Best of three, first index on ties (same pick as argmax).
    use02 = n02 > n01
    bx = torch.where(use02, c02[0], c01[0])
    by = torch.where(use02, c02[1], c01[1])
    bz = torch.where(use02, c02[2], c01[2])
    bn = torch.where(use02, n02, n01)
    use12 = n12 > bn
    bx = torch.where(use12, c12[0], bx)
    by = torch.where(use12, c12[1], by)
    bz = torch.where(use12, c12[2], bz)
    bn = torch.where(use12, n12, bn)
    norm = torch.sqrt(torch.clamp(bn, min=0.0))
    ok = norm > 1e-20
    inv = torch.where(ok, 1.0 / torch.clamp(norm, min=1e-20),
                      torch.zeros_like(norm))
    # Degenerate (repeated eigenvalue / zero matrix): fall back to +z.
    vx = torch.where(ok, bx * inv, torch.zeros_like(bx))
    vy = torch.where(ok, by * inv, torch.zeros_like(by))
    vz = torch.where(ok, bz * inv, torch.ones_like(bz))
    return vx, vy, vz
