"""Flip-hypothesis consensus matching, twin of
`rift_tpu/registration/consensus.py`, batched over pairs.

The 'change_coords' frame is defined up to the 4 right-handed sign
assignments of its axes (`ops/lrf.py:lrf_flip_hypotheses`). The source's
features are taken under each of them; each hypothesis is matched against
the target by mutual nearest neighbours (within a motion-prior gate when
one is given) and scored by rigidity: the
number of match pairs (a, b) whose within-cloud distances agree,
|‖p_a − p_b‖ − ‖q_a − q_b‖| < tau. The most rigid hypothesis is kept.
"""
from __future__ import annotations

import torch

from ..ops.neighbors import (gated_mutual_nearest_neighbors, gather_rows,
                             mutual_nearest_neighbors, pairwise_sqdist)

Tensor = torch.Tensor


def rigidity_score(src: Tensor, dst: Tensor, i1: Tensor, i2: Tensor, mask: Tensor,
                   tau: float) -> Tensor:
    """Number of rigidity-consistent match pairs, int64 [...].

    src [..., n, 3], dst [..., m, 3], matches (i1, i2, mask) [..., k] as
    `mutual_nearest_neighbors` gives them: the count of (a, b), both
    masked, with |‖p_a − p_b‖ − ‖q_a − q_b‖| < tau, from the same
    ‖x‖² + ‖y‖² − 2·x·yᵀ expansion as the reference."""
    p = gather_rows(src, i1)
    q = gather_rows(dst, i2)
    dp = torch.sqrt(pairwise_sqdist(p, p))
    dq = torch.sqrt(pairwise_sqdist(q, q))
    ok = ((dp - dq).abs() < tau) & mask[..., :, None] & mask[..., None, :]
    return ok.sum((-2, -1))


def hypothesis_matches(src: Tensor, dst: Tensor, feat_src_h: Tensor, feat_dst: Tensor,
                       tau: float = 0.04, spatial_valid: Tensor | None = None
                       ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Mutual-NN matches and rigidity score of every hypothesis: src
    [b, n, 3], dst [b, m, 3], feat_src_h [b, H, n, c], feat_dst [b, m, c]
    -> (i1s, i2s, masks [b, H, n], scores int64 [b, H]). `spatial_valid`
    [b, n, m] restricts every hypothesis to the allowed candidate pairs
    (`gated_mutual_nearest_neighbors`)."""
    hyps = feat_src_h.shape[1]
    feat_dst_h = feat_dst[:, None].expand(-1, hyps, -1, -1)
    if spatial_valid is None:
        i1s, i2s, masks = mutual_nearest_neighbors(feat_src_h, feat_dst_h)  # [n], [b, H, n] x2
    else:
        i1s, i2s, masks = gated_mutual_nearest_neighbors(
            feat_src_h, feat_dst_h, spatial_valid[:, None].expand(-1, hyps, -1, -1))
    i1s = i1s.expand(i2s.shape)
    scores = rigidity_score(src[:, None].expand(-1, hyps, -1, -1),
                            dst[:, None].expand(-1, hyps, -1, -1), i1s, i2s, masks, tau)
    return i1s, i2s, masks, scores


def choose_hypothesis(i1s: Tensor, i2s: Tensor, masks: Tensor, scores: Tensor
                      ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The matches [b, n] x3 of the hypothesis with the highest score, the
    first on ties (as `jnp.argmax`), and its index h [b]."""
    h = torch.argmax(scores, dim=-1)
    pick = h[:, None, None].expand(-1, 1, i2s.shape[-1])

    def chosen(x: Tensor) -> Tensor:
        return torch.gather(x, 1, pick)[:, 0]

    return chosen(i1s), chosen(i2s), chosen(masks), h


def consensus_match(src: Tensor, dst: Tensor, feat_src_h: Tensor, feat_dst: Tensor,
                    tau: float = 0.04, spatial_valid: Tensor | None = None
                    ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Match under every source-frame hypothesis and keep the most rigid.

    src [b, n, 3], dst [b, m, 3], feat_src_h [b, H, n, c] (the source's
    features under H frame hypotheses), feat_dst [b, m, c] ->
    (i1 [b, n], i2 [b, n], mask [b, n], h [b]): `choose_hypothesis` of
    `hypothesis_matches`. `spatial_valid` [b, n, m] (optional) is the
    motion-prior gate of every hypothesis's matching.
    """
    return choose_hypothesis(*hypothesis_matches(src, dst, feat_src_h, feat_dst, tau,
                                                 spatial_valid))
