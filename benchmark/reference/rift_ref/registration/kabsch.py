"""Weighted Kabsch alignment, twin of `rift_tpu/registration/kabsch.py`.

The rotation is the closed-form polar factor from the eigenbasis of HᵀH
(`ops/eig3.py:eigh_sym3`), not an SVD: the two differ on degenerate H.
"""
from __future__ import annotations

import torch

from ..ops.eig3 import eigh_sym3, unit_axis

Tensor = torch.Tensor


def _norm(v: Tensor) -> Tensor:
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def rotation_from_h(h: Tensor) -> Tensor:
    """R = argmax over SO(3) of tr(RᵀH), for [..., 3, 3] H (H ≈ 0 ->
    identity; rank <= 1 -> any completion)."""
    hth = torch.matmul(h.transpose(-1, -2), h)
    vals, vecs = eigh_sym3(hth)
    v0, v1, v2 = vecs[..., 0], vecs[..., 1], vecs[..., 2]
    sigma2 = torch.sqrt(torch.clamp(vals[..., 2], min=0.0))
    hv2 = torch.matmul(h, v2[..., None])[..., 0]
    u2 = hv2 / torch.clamp(_norm(hv2), min=1e-20)
    hv1 = torch.matmul(h, v1[..., None])[..., 0]
    hv1 = hv1 - (hv1 * u2).sum(-1, keepdim=True) * u2
    n1 = _norm(hv1)
    alt = torch.linalg.cross(u2, unit_axis(0, h).expand(u2.shape))
    alt2 = torch.linalg.cross(u2, unit_axis(1, h).expand(u2.shape))
    alt = torch.where(_norm(alt) > 0.1, alt, alt2)
    alt = alt / torch.clamp(_norm(alt), min=1e-20)
    u1 = torch.where(n1 > 1e-12 * torch.clamp(sigma2[..., None], min=1.0),
                     hv1 / torch.clamp(n1, min=1e-20), alt)
    u0 = torch.linalg.cross(u1, u2)
    rot = (u0[..., :, None] * v0[..., None, :] + u1[..., :, None] * v1[..., None, :]
           + u2[..., :, None] * v2[..., None, :])
    # H ~ 0: no signal, identity. The norm test is needed besides sigma2:
    # for H = 0 the closed form's p >= 1e-15 floor leaves a spurious
    # eigenvalue ~1.7e-15 (sigma2 ~4e-8); the reference reaches identity
    # there only through a NaN from jnp.linalg.det on the CPU.
    signal = (sigma2 > 1e-12) & (torch.linalg.matrix_norm(h) > 1e-12)
    eye = torch.eye(3, dtype=h.dtype, device=h.device).expand(rot.shape)
    return torch.where(signal[..., None, None], rot, eye)


def weighted_kabsch(src: Tensor, dst: Tensor, weights: Tensor | None = None) -> Tensor:
    """Best-fit T [..., 4, 4] with T·src ≈ dst; src/dst [..., n, 3],
    weights [..., n] >= 0 (zero total weight -> identity)."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    w = weights[..., None]
    wsum = torch.clamp(w.sum(-2, keepdim=True), min=1e-12)
    cs = (src * w).sum(-2, keepdim=True) / wsum
    cd = (dst * w).sum(-2, keepdim=True) / wsum
    s = src - cs
    d = dst - cd
    h = torch.matmul((s * w).transpose(-1, -2), d)  # Σ w·s⊗d
    rot = rotation_from_h(h.transpose(-1, -2))
    t = cd[..., 0, :] - torch.matmul(rot, cs[..., 0, :, None])[..., 0]
    out = torch.zeros(src.shape[:-2] + (4, 4), dtype=src.dtype, device=src.device)
    out[..., :3, :3] = rot
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    eye = torch.eye(4, dtype=src.dtype, device=src.device).expand(out.shape)
    degenerate = weights.sum(-1) <= 1e-12
    return torch.where(degenerate[..., None, None], eye, out)
