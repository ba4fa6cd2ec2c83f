"""Correspondence RANSAC, twin of `rift_tpu/registration/ransac.py:ransac_pose`,
batched over pairs.

Every hypothesis is drawn and scored at once: [b, K, 3] samples of valid
matches -> the edge-length check -> a Kabsch fit of each sample -> the
[b, K, n] residuals -> the hypothesis with the most inliers (the first on
ties, as `jnp.argmax`) -> a refit on its inliers -> Tukey IRLS steps on all
matches -> the final inliers. It has fixed shapes and no host sync.

The draw and the rest are apart so that a caller can hand in given samples
(the tests feed the reference's): `ransac_samples` draws from an explicit
`torch.Generator` (the reference's key becomes a generator, whose stream
differs), `ransac_from_samples` does the rest. At b = 64, K = 1000 and
n = 1024 the moved points [b, K, n, 3] take 0.79 GB in f32.
"""
from __future__ import annotations

import torch

from ..ops.se3 import transform_points
from .kabsch import weighted_kabsch

Tensor = torch.Tensor


def gumbel_top_samples(valid: Tensor, gumbel: Tensor, sample_size: int = 3) -> Tensor:
    """The reference's Gumbel top-k draw from given noise: valid [b, n]
    bool, gumbel [b, K, n] -> indices [b, K, sample_size], the valid
    matches of largest noise first. A row with fewer valid matches than
    `sample_size` takes all of them, then the lowest invalid indices in
    order, as `jax.lax.top_k` breaks the ties of its −inf keys."""
    b, n = valid.shape
    logits = torch.where(valid, torch.zeros_like(valid, dtype=gumbel.dtype),
                         torch.full_like(valid, float("-inf"), dtype=gumbel.dtype))
    top = torch.topk(logits[:, None, :] + gumbel, sample_size, dim=-1).indices
    arange = torch.arange(n, device=valid.device)
    # The invalid indices in ascending order lead this key's sort.
    invalid_first = torch.sort(torch.where(valid, arange + n, arange), dim=-1).values[:, :sample_size]
    num_valid = valid.sum(-1, keepdim=True)  # [b, 1]
    slot = torch.arange(sample_size, device=valid.device)
    fill = torch.gather(invalid_first, 1, torch.clamp(slot - num_valid, min=0))  # [b, s]
    return torch.where((slot < num_valid)[:, None, :], top, fill[:, None, :])


def ransac_samples(valid: Tensor, num_hypotheses: int, generator: torch.Generator,
                   sample_size: int = 3) -> Tensor:
    """Draw [b, K, sample_size] distinct valid match indices per hypothesis:
    Gumbel noise from `generator` (on the tensors' device), then
    `gumbel_top_samples`."""
    b, n = valid.shape
    u = torch.rand((b, num_hypotheses, n), generator=generator, device=valid.device)
    tiny = torch.finfo(u.dtype).tiny
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    return gumbel_top_samples(valid, gumbel, sample_size)


def _tukey_step(transform: Tensor, src: Tensor, dst: Tensor, valid: Tensor, c: float) -> Tensor:
    """One Tukey-biweight IRLS refit at scale c over all valid matches."""
    u = torch.linalg.vector_norm(transform_points(transform, src) - dst, dim=-1) / c
    w = torch.where((u < 1.0) & valid, (1.0 - u ** 2) ** 2, torch.zeros_like(u))
    return weighted_kabsch(src, dst, w)


def ransac_from_samples(src: Tensor, dst: Tensor, valid: Tensor, samples: Tensor,
                        inlier_threshold: float = 0.08, edge_similarity: float = 0.9,
                        irls_iterations: int = 3, irls_shrink: float = 1.0
                        ) -> tuple[Tensor, Tensor, Tensor]:
    """src/dst [b, n, 3] matched points, valid [b, n] bool, samples
    [b, K, s] match indices -> (transform [b, 4, 4], final inliers [b, n],
    each hypothesis's score [b, K]: its inlier count, 0 where its sample
    fails the check; the winner is its first maximum, `argmax`). A
    sample passes the edge-length check when
    min(e_s, e_d)/max(e_s, e_d, 1e-12) > edge_similarity for each of its
    edges. With no valid match the result is the identity. Strict f32 is
    the caller's to set."""
    b, k, s = samples.shape
    flat = samples.reshape(b, k * s)
    s_pts = torch.gather(src, 1, flat[..., None].expand(-1, -1, 3)).reshape(b, k, s, 3)
    d_pts = torch.gather(dst, 1, flat[..., None].expand(-1, -1, 3)).reshape(b, k, s, 3)
    es = torch.linalg.vector_norm(s_pts[..., :, None, :] - s_pts[..., None, :, :], dim=-1)
    ed = torch.linalg.vector_norm(d_pts[..., :, None, :] - d_pts[..., None, :, :], dim=-1)
    ratio = torch.minimum(es, ed) / torch.clamp(torch.maximum(es, ed), min=1e-12)
    diag = torch.eye(s, dtype=torch.bool, device=src.device)
    ok = ((ratio > edge_similarity) | diag).all(-1).all(-1)  # [b, K]

    hyp = weighted_kabsch(s_pts, d_pts)  # [b, K, 4, 4]
    resid = torch.linalg.vector_norm(transform_points(hyp, src[:, None]) - dst[:, None], dim=-1)
    inliers = (resid < inlier_threshold) & valid[:, None, :]  # [b, K, n]
    score = inliers.sum(-1) * ok
    best = torch.argmax(score, dim=-1)  # the first maximum
    best_inliers = torch.gather(inliers, 1, best[:, None, None].expand(-1, 1, src.shape[1]))[:, 0]
    refined = weighted_kabsch(src, dst, best_inliers.to(src.dtype))
    for _ in range(irls_iterations):
        refined = _tukey_step(refined, src, dst, valid, inlier_threshold)
    if irls_shrink != 1.0:
        for _ in range(2):
            refined = _tukey_step(refined, src, dst, valid, inlier_threshold * irls_shrink)
    resid = torch.linalg.vector_norm(transform_points(refined, src) - dst, dim=-1)
    return refined, (resid < inlier_threshold) & valid, score


def ransac_pose(src: Tensor, dst: Tensor, valid: Tensor, generator: torch.Generator,
                num_hypotheses: int = 512, sample_size: int = 3,
                inlier_threshold: float = 0.08, edge_similarity: float = 0.9,
                irls_iterations: int = 3, irls_shrink: float = 1.0) -> tuple[Tensor, Tensor]:
    """Robust SE(3) of b pairs of matches: `ransac_samples` from
    `generator`, then `ransac_from_samples` -> (transform [b, 4, 4],
    inliers [b, n])."""
    samples = ransac_samples(valid, num_hypotheses, generator, sample_size)
    transform, inliers, _ = ransac_from_samples(src, dst, valid, samples, inlier_threshold,
                                                edge_similarity, irls_iterations, irls_shrink)
    return transform, inliers
