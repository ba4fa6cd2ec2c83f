"""rift_tpu_torch's solvers against rift_tpu's on the same numpy inputs:
`exp_so3`, FGR (`gnc_pose(kind="gm")`, `fgr_pose`), RANSAC from the
reference's own samples (its Gumbel top-k recomputed here from its key),
point-to-point and point-to-plane ICP, and `register_pair_from_matches` /
`register_pair` for all 13 method names."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.ops.precision import f32_geometry as j_f32
from rift_tpu.ops.se3 import exp_so3 as j_exp_so3
from rift_tpu.registration import gnc_pose as j_gnc
from rift_tpu.registration.gnc import fgr_pose as j_fgr
from rift_tpu.registration.icp import icp_plane_pose as j_icp_plane
from rift_tpu.registration.icp import icp_pose as j_icp
from rift_tpu.registration.kabsch import weighted_kabsch as j_kabsch
from rift_tpu.registration.pipeline import METHODS as J_METHODS
from rift_tpu.registration.pipeline import register_pair as j_register_pair
from rift_tpu.registration.pipeline import register_pair_from_matches as j_from_matches
from rift_tpu.registration.ransac import ransac_pose as j_ransac
from rift_tpu_torch.ops.normals import estimate_normals
from rift_tpu_torch.ops.se3 import exp_so3
from rift_tpu_torch.registration import (METHODS, fgr_pose, gnc_pose, icp_plane_pose, icp_pose,
                                         ransac_from_samples, ransac_pose, ransac_samples,
                                         register_pair, register_pair_from_matches)
from rift_tpu_torch.registration import ransac as ransac_module
from rift_tpu_torch.registration.ransac import gumbel_top_samples

# Poses of the deterministic solvers: the same iterations from the same
# start, Kabsch and the 6x6 solves rounding differently: max abs entry.
POSE_TOL = 1e-4
# A RANSAC sample or refit set is nearly rank 1 when its cross-covariance's
# second singular value is below RANK_SHARE of its first: its rotation is
# not unique. Such hypotheses may score apart; such refits are held by
# where they move the kept points: within RANK_MOVE, a tenth of the inlier
# threshold.
RANK_SHARE, RANK_MOVE = 0.05, 8e-3


def _rot(rng):
    q, _ = np.linalg.qr(rng.randn(3, 3))
    return q * np.sign(np.linalg.det(q))


def _matches(rng, b, n, outliers=0.3, noise=0.005):
    """Putative matches: src [b, n, 3], dst = R·src + t + noise with a share
    of outliers, valid [b, n]; and the ground-truth transforms."""
    src = rng.uniform(-1, 1, (b, n, 3))
    gt = np.tile(np.eye(4), (b, 1, 1))
    dst = np.empty_like(src)
    for i in range(b):
        gt[i, :3, :3], gt[i, :3, 3] = _rot(rng), rng.uniform(-0.5, 0.5, 3)
        dst[i] = src[i] @ gt[i, :3, :3].T + gt[i, :3, 3]
    dst += noise * rng.randn(*dst.shape)
    bad = rng.rand(b, n) < outliers
    dst[bad] = rng.uniform(-1.5, 1.5, (int(bad.sum()), 3))
    valid = rng.rand(b, n) > 0.1
    return src.astype(np.float32), dst.astype(np.float32), valid, gt.astype(np.float32)


@pytest.mark.parametrize("angle", [0.0, 1e-8, 1.0, np.pi - 1e-6])
def test_exp_so3_matches_reference(rng, angle):
    axis = rng.randn(4, 3)
    w = (axis / np.linalg.norm(axis, axis=-1, keepdims=True) * angle).astype(np.float32)
    got = exp_so3(torch.from_numpy(w)).numpy()
    want = np.asarray(j_exp_so3(jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got @ np.swapaxes(got, -1, -2), np.broadcast_to(np.eye(3), got.shape),
                               atol=1e-6)


def test_fgr_matches_reference(rng):
    """gnc_pose(kind="gm") and fgr_pose: 64 fixed iterations, μ from 64."""
    src, dst, valid, _ = _matches(rng, 3, 128)
    valid[2] = False  # no valid match: the identity
    t, w = fgr_pose(*map(torch.from_numpy, (src, dst, valid)))
    t_gm, w_gm = gnc_pose(*map(torch.from_numpy, (src, dst, valid)), noise_bound=0.04,
                          max_iterations=64, kind="gm")
    assert torch.equal(t, t_gm) and torch.equal(w, w_gm)
    wt, ww = jax.vmap(lambda s, d, v: j_fgr(s, d, v))(*map(jnp.asarray, (src, dst, valid)))
    np.testing.assert_allclose(t.numpy(), np.asarray(wt), rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(ww), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(t[2].numpy(), np.eye(4))
    # Another bound and length, and a start of its own.
    t, w = gnc_pose(*map(torch.from_numpy, (src, dst, valid)), noise_bound=0.02,
                    max_iterations=10, kind="gm")
    wt, ww = jax.vmap(lambda s, d, v: j_gnc(s, d, v, noise_bound=0.02, max_iterations=10,
                                            kind="gm"))(*map(jnp.asarray, (src, dst, valid)))
    np.testing.assert_allclose(t.numpy(), np.asarray(wt), rtol=0, atol=POSE_TOL)
    with pytest.raises(ValueError, match="GNC kind"):
        gnc_pose(*map(torch.from_numpy, (src, dst, valid)), kind="huber")


def _ref_draw(key, valid, num_hypotheses):
    """ransac_pose's draw (rift_tpu/registration/ransac.py): its Gumbel
    noise [K, n] and its top-3 samples [K, 3]."""
    k1, _ = jax.random.split(key)
    logits = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)
    gumbel = jax.random.gumbel(k1, (num_hypotheses, valid.shape[0]))
    _, samples = jax.lax.top_k(logits[None, :] + gumbel, 3)
    return np.asarray(gumbel), np.asarray(samples)


def _ref_samples(keys, valid, num_hypotheses):
    return np.stack([_ref_draw(k, v, num_hypotheses)[1] for k, v in zip(keys, valid)])


@j_f32
def _ref_winner(src, dst, valid, samples, threshold=0.08, edge=0.9):
    """The hypothesis ransac_pose keeps, with its scores: the reference's
    scoring on its samples."""
    s_pts, d_pts = src[samples], dst[samples]

    def edge_ok(ps, pd):
        es = jnp.linalg.norm(ps[:, None] - ps[None], axis=-1)
        ed = jnp.linalg.norm(pd[:, None] - pd[None], axis=-1)
        ratio = jnp.minimum(es, ed) / jnp.maximum(jnp.maximum(es, ed), 1e-12)
        return jnp.all((ratio > edge) | jnp.eye(3, dtype=bool))

    ok = jax.vmap(edge_ok)(s_pts, d_pts)
    hyp = jax.vmap(j_kabsch)(s_pts, d_pts)
    moved = jnp.einsum("kij,nj->kni", hyp[:, :3, :3], src) + hyp[:, None, :3, 3]
    score = jnp.sum((jnp.linalg.norm(moved - dst[None], axis=-1) < threshold) & valid, -1) * ok
    return int(jnp.argmax(score)), np.asarray(score)


def _thin_samples(src, dst, samples):
    """The hypotheses [K] whose 3-point sample is nearly rank 1: its
    cross-covariance's second singular value below RANK_SHARE of its
    first."""
    s_pts, d_pts = src[samples], dst[samples]  # [K, 3, 3]
    h = np.einsum("kni,knj->kij", s_pts - s_pts.mean(1, keepdims=True),
                  d_pts - d_pts.mean(1, keepdims=True))
    sv = np.linalg.svd(h, compute_uv=False)
    return sv[:, 1] < RANK_SHARE * sv[:, 0]


def _hold_ransac(src, dst, valid, num_hypotheses=64, **kw):
    """ransac_from_samples on the reference's samples against ransac_pose
    with the same keys: the hypotheses' scores (the reference's scoring
    here on its samples), the winner index, the final inliers and the
    pose.
    A refit on fewer than 3 matches, or on nearly collinear ones, is
    rank-deficient: any rotation about their line is (nearly) optimal and
    rounding picks one (ROADMAP §3, the rank-1 note). Where the second
    singular value of the kept matches' cross-covariance is below
    RANK_SHARE of the first, the two poses must move the kept sources to
    within RANK_MOVE of each other."""
    b = src.shape[0]
    keys = [jax.random.PRNGKey(i) for i in range(b)]
    samples = _ref_samples(keys, valid, num_hypotheses)
    t, inl, score = ransac_from_samples(*map(torch.from_numpy, (src, dst, valid)),
                                        torch.from_numpy(samples), **kw)
    for i in range(b):
        wt, winl = j_ransac(keys[i], *map(jnp.asarray, (src[i], dst[i], valid[i])),
                            num_hypotheses=num_hypotheses, **kw)
        winner, scores = _ref_winner(*map(jnp.asarray, (src[i], dst[i], valid[i], samples[i])),
                                     threshold=kw.get("inlier_threshold", 0.08))
        # A nearly rank-1 sample (collinear draws) has no unique rotation,
        # and the two fits may score apart (ROADMAP §3); every other
        # hypothesis scores the same, and the winner is the same wherever
        # no such sample reaches the best score.
        thin = _thin_samples(src[i], dst[i], samples[i])
        np.testing.assert_array_equal(score[i].numpy()[~thin], scores[~thin])
        if max(score[i].numpy()[thin].max(initial=-1), scores[thin].max(initial=-1)) \
                < scores.max():
            assert int(torch.argmax(score[i])) == winner
        np.testing.assert_array_equal(inl[i].numpy(), np.asarray(winl))
        kept, kept_dst = src[i][np.asarray(winl)], dst[i][np.asarray(winl)]
        sv = np.linalg.svd((kept - kept.mean(0)).T @ (kept_dst - kept_dst.mean(0)),
                           compute_uv=False) if len(kept) else [0.0, 0.0]
        if len(kept) >= 3 and sv[1] >= RANK_SHARE * sv[0]:
            np.testing.assert_allclose(t[i].numpy(), np.asarray(wt), rtol=0, atol=POSE_TOL)
        else:
            def moved(m):
                return kept @ m[:3, :3].T + m[:3, 3]
            np.testing.assert_allclose(moved(t[i].numpy()), moved(np.asarray(wt)), rtol=0,
                                       atol=RANK_MOVE)
    return t, inl, score, samples


@pytest.mark.parametrize("irls_shrink", [1.0, 0.5])
def test_ransac_from_reference_samples_matches_reference(rng, irls_shrink):
    src, dst, valid, gt = _matches(rng, 3, 160)
    t, inl, _, _ = _hold_ransac(src, dst, valid, irls_shrink=irls_shrink, irls_iterations=2)
    assert np.abs(t.numpy() - gt).max() < 0.05  # 30% outliers: recovered


def test_ransac_with_tied_scores_keeps_the_first(rng):
    """Noise-free inliers: every all-inlier sample scores the same maximum,
    and both keep the first such hypothesis."""
    src, dst, valid, gt = _matches(rng, 2, 120, outliers=0.4, noise=0.0)
    keys = [jax.random.PRNGKey(i) for i in range(2)]
    samples = _ref_samples(keys, valid, 64)
    for i in range(2):
        winner, scores = _ref_winner(*map(jnp.asarray, (src[i], dst[i], valid[i], samples[i])))
        assert (scores == scores.max()).sum() > 1 and winner == np.argmax(scores)
    _hold_ransac(src, dst, valid)


@pytest.mark.parametrize("num_valid", [0, 1, 2, 3])
def test_ransac_with_few_valid_matches(rng, num_valid):
    """With fewer valid matches than a sample, the draw fills the sample
    with the lowest invalid indices, as jax.lax.top_k orders its -inf keys;
    with none valid the pose is the identity."""
    src, dst, _, _ = _matches(rng, 2, 64)
    valid = np.zeros((2, 64), bool)
    for i in range(2):
        valid[i, rng.choice(64, num_valid, replace=False)] = True
    keys = [jax.random.PRNGKey(i) for i in range(2)]
    for i in range(2):
        gumbel, samples = _ref_draw(keys[i], valid[i], 32)
        got = gumbel_top_samples(torch.from_numpy(valid[i:i + 1]),
                                 torch.from_numpy(np.array(gumbel[None])))
        np.testing.assert_array_equal(got[0].numpy(), samples)
    t, inl, _, _ = _hold_ransac(src, dst, valid, num_hypotheses=32)
    assert int(inl.sum()) <= 2 * num_valid
    if num_valid == 0:
        np.testing.assert_array_equal(t.numpy(), np.tile(np.eye(4), (2, 1, 1)))


def test_ransac_samples_are_distinct_valid_draws(rng):
    """The port's own draw: from an explicit generator, reproducible, three
    distinct valid indices per hypothesis; ransac_pose recovers the pose."""
    src, dst, valid, gt = _matches(rng, 2, 160)
    v = torch.from_numpy(valid)
    a = ransac_samples(v, 200, torch.Generator().manual_seed(3))
    b = ransac_samples(v, 200, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.shape == (2, 200, 3)
    assert bool(torch.gather(v[:, None].expand(-1, 200, -1), 2, a).all())
    srt = a.sort(-1).values
    assert bool((srt[..., 1:] != srt[..., :-1]).all())
    t, _ = ransac_pose(*map(torch.from_numpy, (src, dst, valid)),
                       torch.Generator().manual_seed(0), num_hypotheses=200)
    assert np.abs(t.numpy() - gt).max() < 0.05


def _plane_cloud(rng, n):
    """A plane-dominated cloud: a floor with a low ridge (the plane system
    leaves in-plane directions nearly free)."""
    xy = rng.uniform(-1, 1, (n, 2))
    z = 0.15 * np.exp(-((xy[:, 0] - 0.3) ** 2) / 0.05) + 0.002 * rng.randn(n)
    return np.concatenate([xy, z[:, None]], -1)


def _icp_case(rng, cloud, b=2, n=192):
    """Target = a rigid motion of the source resampled with noise; starts
    near the truth (perturbed by a few degrees and centimetres)."""
    src = np.stack([_plane_cloud(rng, n) if cloud == "plane" else rng.uniform(-1, 1, (n, 3))
                    for _ in range(b)])
    init = np.tile(np.eye(4), (b, 1, 1))
    dst = np.empty_like(src)
    for i in range(b):
        rot = _rot(rng) if cloud != "plane" else np.eye(3)
        t = rng.uniform(-0.3, 0.3, 3)
        dst[i] = src[i] @ rot.T + t + 0.003 * rng.randn(n, 3)
        w = rng.randn(3)
        w *= np.deg2rad(4.0) / np.linalg.norm(w)
        init[i, :3, :3] = np.asarray(j_exp_so3(jnp.asarray(w, jnp.float32))) @ rot
        init[i, :3, 3] = t + rng.uniform(-0.04, 0.04, 3)
    return src.astype(np.float32), dst.astype(np.float32), init.astype(np.float32)


# On the plane-dominated cloud the reference's point-to-plane iteration
# is no contraction along the plane's free directions (its yaw jumps by up
# to 7 degrees between iterations and never settles), so a rounding
# difference grows about tenfold an iteration (1e-7 after 1, 3e-5 after 5,
# 0.1 after 10): there the plane step is held after PLANE_ITERATIONS.
PLANE_ITERATIONS = {"random": 20, "plane": 3}


@pytest.mark.parametrize("start", ["identity", "perturbed"])
@pytest.mark.parametrize("cloud", ["random", "plane"])
def test_icp_matches_reference(rng, cloud, start):
    src, dst, init = _icp_case(rng, cloud)
    given = None if start == "identity" else init
    t = icp_pose(torch.from_numpy(src), torch.from_numpy(dst),
                 None if given is None else torch.from_numpy(given))
    normals = estimate_normals(torch.from_numpy(dst))
    iterations = PLANE_ITERATIONS[cloud]
    tp = icp_plane_pose(torch.from_numpy(src), torch.from_numpy(dst), normals,
                        None if given is None else torch.from_numpy(given),
                        max_correspondence_distance=0.1, max_iterations=iterations)
    for i in range(src.shape[0]):
        kw = {} if given is None else dict(init_transform=jnp.asarray(given[i]))
        want = np.asarray(j_icp(jnp.asarray(src[i]), jnp.asarray(dst[i]), **kw))
        want_p = np.asarray(j_icp_plane(jnp.asarray(src[i]), jnp.asarray(dst[i]),
                                        jnp.asarray(normals[i].numpy()),
                                        max_correspondence_distance=0.1,
                                        max_iterations=iterations, **kw))
        np.testing.assert_allclose(t[i].numpy(), want, rtol=0, atol=POSE_TOL)
        np.testing.assert_allclose(tp[i].numpy(), want_p, rtol=0, atol=POSE_TOL)
        np.testing.assert_allclose(tp[i, :3, :3].numpy() @ tp[i, :3, :3].numpy().T, np.eye(3),
                                   atol=1e-5)


def _method_case(rng, b=2, n=160):
    """Two noisy copies of one closed surface (a bumpy ellipsoid, so the
    normals and the plane steps are well posed), the target moved by a
    small rigid motion; matches with 30% wrong targets and 10% masked."""
    u = rng.uniform(0, 2 * np.pi, (b, n))
    v = rng.uniform(0.1, np.pi - 0.1, (b, n))
    rad = 1.0 + 0.15 * np.sin(3 * u) * np.sin(2 * v)
    src = rad[..., None] * np.stack([np.sin(v) * np.cos(u), 0.7 * np.sin(v) * np.sin(u),
                                     0.5 * np.cos(v)], -1)
    dst = np.empty_like(src)
    for i in range(b):
        rot = np.asarray(j_exp_so3(jnp.asarray(rng.randn(3) * 0.1, jnp.float32)))
        dst[i] = src[i] @ rot.T + rng.uniform(-0.05, 0.05, 3) + 0.003 * rng.randn(n, 3)
    idx1 = np.stack([rng.permutation(n) for _ in range(b)])
    idx2 = idx1.copy()
    wrong = rng.rand(b, n) < 0.3
    idx2[wrong] = rng.randint(0, n, int(wrong.sum()))
    mask = rng.rand(b, n) > 0.1
    return src.astype(np.float32), dst.astype(np.float32), idx1, idx2, mask


def test_register_pair_from_matches_all_methods_match_reference(rng, monkeypatch):
    """All 13 names from the same matches; the RANSAC ones on the
    reference's samples of each pair's key."""
    assert METHODS == J_METHODS and len(METHODS) == 13
    src, dst, idx1, idx2, mask = _method_case(rng)
    keys = [jax.random.PRNGKey(10 + i) for i in range(2)]
    num_hypotheses = 128
    samples = _ref_samples(keys, mask, num_hypotheses)
    drawn = []

    def given(valid, k, generator, sample_size=3):
        drawn.append(k)
        return torch.from_numpy(samples)

    monkeypatch.setattr(ransac_module, "ransac_samples", given)
    for method in METHODS:
        t, inl = register_pair_from_matches(*map(torch.from_numpy, (src, dst, idx1, idx2, mask)),
                                            method=method, num_hypotheses=num_hypotheses)
        assert t.shape == (2, 4, 4) and inl.shape == (2, 160) and bool(torch.isfinite(t).all())
        for i in range(2):
            if method == "icp":  # the reference takes it in register_pair only
                want_t, want_inl = j_register_pair(jnp.asarray(src[i]), jnp.asarray(dst[i]),
                                                   None, None, method="icp")
            else:
                want_t, want_inl = j_from_matches(
                    *map(jnp.asarray, (src[i], dst[i], idx1[i], idx2[i], mask[i])),
                    key=keys[i], method=method, num_hypotheses=num_hypotheses)
            np.testing.assert_allclose(t[i].numpy(), np.asarray(want_t), rtol=0, atol=POSE_TOL,
                                       err_msg=method)
            # TEASER's kept set and FGR's weights > 0.5 are thresholds on
            # rounded values: equal here, as no match sits on the edge.
            np.testing.assert_array_equal(inl[i].numpy(), np.asarray(want_inl), err_msg=method)
    assert drawn == [num_hypotheses] * 4  # the four ransac names, one draw each


def test_register_pair_methods_and_names(rng):
    """register_pair's 'icp' skips the matching (ICP from the identity, a
    mask of ones); the other names match features first; an unknown name
    raises. The default generator is seeded with 0: two calls agree."""
    src, dst, _, _, _ = _method_case(rng)
    feat = rng.randn(2, 160, 8).astype(np.float32)
    feat2 = feat + 0.01 * rng.randn(2, 160, 8).astype(np.float32)
    args = tuple(map(torch.from_numpy, (src, dst, feat, feat2)))
    t, inl = register_pair(*args, method="icp")
    np.testing.assert_array_equal(t.numpy(), icp_pose(args[0], args[1]).numpy())
    assert bool(inl.all()) and inl.shape == (2, 160)
    a, _ = register_pair(*args, method="ransac+pl", num_hypotheses=64)
    b, _ = register_pair(*args, method="ransac+pl", num_hypotheses=64)
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())
    for bad in ("svd", "icp+icp", "teaserpp+pl+icp"):
        with pytest.raises(ValueError, match="unknown method"):
            register_pair(*args, method=bad)
