"""GNC-TLS robust pose, twin of `rift_tpu/registration/gnc.py:gnc_pose`
with `kind="tls", early_exit=True`, batched over pairs.

Each iteration updates the TLS weights (Yang et al. 2020, eq. 14) from the
residuals of the current transform, re-solves a weighted Kabsch, and grows
μ by `gnc_factor`. A pair stops at its fixed point — the first iteration
whose weights repeat the previous ones — or after `max_iterations`; a
stopped pair keeps its carry while the others go on, as the reference's
vmapped `lax.while_loop` does.
"""
from __future__ import annotations

import torch

from .kabsch import weighted_kabsch

Tensor = torch.Tensor


def _residuals(transform: Tensor, src: Tensor, dst: Tensor) -> Tensor:
    rot = transform[..., :3, :3]
    t = transform[..., :3, 3]
    moved = torch.matmul(src, rot.transpose(-1, -2)) + t[..., None, :]
    return torch.linalg.vector_norm(moved - dst, dim=-1)


def _tls_weights(transform, mu, src, dst, valid, c2):
    r2 = _residuals(transform, src, dst) ** 2
    mu = mu[..., None]
    th1 = (mu + 1.0) / mu * c2
    th2 = mu / (mu + 1.0) * c2
    mid = torch.sqrt(c2 * mu * (mu + 1.0) / torch.clamp(r2, min=1e-20)) - mu
    w = torch.where(r2 >= th1, torch.zeros_like(r2),
                    torch.where(r2 <= th2, torch.ones_like(r2), mid))
    return w * valid


def gnc_pose(src: Tensor, dst: Tensor, valid: Tensor, noise_bound: float = 0.02,
             gnc_factor: float = 1.4, max_iterations: int = 100
             ) -> tuple[Tensor, Tensor]:
    """src/dst [b, n, 3] putative matches, valid [b, n] bool ->
    (transform [b, 4, 4], final weights [b, n]). Strict f32 is the caller's
    to set (`ops/precision.py:f32_geometry`, as `register_batch` does)."""
    c2 = noise_bound * noise_bound
    valid = valid.to(src.dtype)
    transform = weighted_kabsch(src, dst, valid)
    r2 = _residuals(transform, src, dst) ** 2
    r2_max = torch.where(valid > 0, r2, torch.zeros_like(r2)).amax(-1)
    mu = torch.clamp(c2 / torch.clamp(2.0 * r2_max - c2, min=1e-12), min=1e-6)
    w_prev = valid
    it = 0
    active = torch.ones(src.shape[0], dtype=torch.bool, device=src.device)
    while it < max_iterations and bool(active.any()):
        w = _tls_weights(transform, mu, src, dst, valid, c2)
        new_t = weighted_kabsch(src, dst, w)
        done = (w == w_prev).all(-1) & (it > 0)
        a = active[..., None]
        transform = torch.where(a[..., None], new_t, transform)
        w_prev = torch.where(a, w, w_prev)
        mu = torch.where(active, mu * gnc_factor, mu)
        active = active & ~done
        it += 1
    return transform, w_prev
