"""rift_tpu_torch's data sources against rift_tpu's on the CPU: the
synthetic indoor sequence (the ICL-NUIM analog), its adjacent-scan pairs
and `get_pairs`' 'icl_nuim' mode, the h5 test pairs and the h5 sequence
on files the tests write, and the `reg_icl_nuim` evaluation at a small
size, stage by stage; the ModelNet40 file loader on a tree the tests
write (random and furthest-point sampling, its caches), and
`ops/sampling.py`."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rift_tpu.train.loop as j_loop
import rift_tpu_torch.train.loop as t_loop
from rift_tpu.data.registration_pairs import H5TestPairs as JaxH5TestPairs
from rift_tpu.data.registration_pairs import SequencePairs as JaxSequencePairs
from rift_tpu.data.registration_pairs import get_pairs as j_get_pairs
from rift_tpu.data.sequences import SequenceConfig as JaxSequenceConfig
from rift_tpu.data.sequences import SyntheticSequence as JaxSyntheticSequence
from rift_tpu.ops.lrf import lrf_basis as j_lrf_basis
from rift_tpu.ops.lrf import lrf_flip_hypotheses as j_lrf_flips
from rift_tpu.ops.normals import estimate_normals as j_normals
from rift_tpu.registration.consensus import consensus_match as j_consensus
from rift_tpu.registration.icp import icp_plane_pose as j_icp_plane
from rift_tpu.registration.icp import icp_pose as j_icp
from rift_tpu.registration.metrics import pair_errors as j_pair_errors
from rift_tpu.registration.ransac import ransac_pose as j_ransac
from rift_tpu.train import get_config as j_get_config
from rift_tpu.train.config import EvalConfig as JaxEvalConfig
from rift_tpu.train.config import ModelConfig as JaxModelConfig
from rift_tpu.train.steps import TrainState as JaxTrainState
from rift_tpu_torch.data import (H5TestPairs, SequenceConfig, SequencePairs, SyntheticSequence,
                                 get_pairs)
from rift_tpu_torch.ops.normals import estimate_normals
from rift_tpu_torch.ops.precision import f32_geometry
from rift_tpu_torch.registration import (consensus_match, icp_plane_pose, icp_pose,
                                         pair_errors, ransac_from_samples)
from rift_tpu_torch.registration import ransac as ransac_module
from rift_tpu_torch.train import evaluate_registration, get_config
from rift_tpu_torch.weights import from_flax
from test_torch_solvers import (POSE_TOL, RANK_MOVE, RANK_SHARE, _ref_samples, _ref_winner,
                                _thin_samples)

FIELDS = ("source", "target", "transform")


def _assert_batches_equal(ours, ref):
    ours, ref = list(ours), list(ref)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        for field in FIELDS:
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


@pytest.mark.parametrize("crop", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_sequence_equals_reference(seed, crop):
    """The whole [T, n, 3] scans and [T, 4, 4] poses bit-equal: one draw
    out of order would change every later scan. The scene keeps its
    16384 points, so make_cloud runs at the objects' size, (16384 - 8189)
    // 5 = 1639 points."""
    kw = dict(num_scans=5, num_points=256, seed=seed, crop=crop)
    ours, ref = SyntheticSequence(SequenceConfig(**kw)), JaxSyntheticSequence(JaxSequenceConfig(**kw))
    assert ours.scans.shape == (5, 256, 3) and ours.scans.dtype == np.float32
    np.testing.assert_array_equal(ours.scans, ref.scans)
    np.testing.assert_array_equal(ours.gt_poses, ref.gt_poses)
    for i, j in ((0, 1), (3, 4), (4, 0)):
        got = ours.relative_gt(i, j)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref.relative_gt(i, j))


def test_sequence_pairs_and_get_pairs_icl_nuim_equal_reference():
    ours = SequencePairs(num_pairs=5, num_points=128)
    ref = JaxSequencePairs(num_pairs=5, num_points=128)
    _assert_batches_equal(ours.batches(2), ref.batches(2))
    src, dst, gt = ours.arrays()
    assert src.shape == dst.shape == (5, 128, 3) and gt.shape == (5, 4, 4)
    np.testing.assert_array_equal(dst[:-1], src[1:])  # pair k + 1 starts at scan k + 1
    pairs = get_pairs(None, 128, "icl_nuim", 5)
    assert isinstance(pairs, SequencePairs)
    _assert_batches_equal(pairs.batches(3), j_get_pairs(None, 128, "icl_nuim", 5).batches(3))


@pytest.fixture
def h5py():
    return pytest.importorskip("h5py")


def test_h5_test_pairs_equal_reference_reader(h5py, tmp_path):
    """A DeepGMR-format file (float64, as the reference's files store it):
    the first-n crop, f32, `get_pairs` picks it over the mode."""
    rs = np.random.RandomState(3)
    m, n = 5, 96
    transform = np.tile(np.eye(4), (m, 1, 1))
    transform[:, :3, 3] = rs.uniform(-0.3, 0.3, (m, 3))
    path = str(tmp_path / "pairs.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("source", data=rs.randn(m, n, 3))
        f.create_dataset("target", data=rs.randn(m, n, 3))
        f.create_dataset("transform", data=transform)
    ours, ref = H5TestPairs(path, 64), JaxH5TestPairs(path, 64)
    assert len(ours) == len(ref) == m
    for i in range(m):
        for a, b in zip(ours[i], ref[i]):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    assert ours[0][0].shape == (64, 3)
    _assert_batches_equal(ours.batches(2), ref.batches(2))
    for mode in ("noise", "icl_nuim"):
        picked = get_pairs(path, 64, mode, num_pairs=2)
        assert isinstance(picked, H5TestPairs) and len(picked) == m
        _assert_batches_equal(picked.batches(4), j_get_pairs(path, 64, mode, 2).batches(4))


def test_sequence_config_path_reads_h5_like_reference(h5py, tmp_path):
    rs = np.random.RandomState(5)
    path = str(tmp_path / "seq.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("scans", data=rs.randn(4, 64, 3))
        f.create_dataset("poses", data=np.tile(np.eye(4), (4, 1, 1)) + 0.1 * rs.randn(4, 4, 4))
    ours = SyntheticSequence(SequenceConfig(path=path))
    ref = JaxSyntheticSequence(JaxSequenceConfig(path=path))
    assert len(ours) == 4 and ours.scans.dtype == ours.gt_poses.dtype == np.float32
    np.testing.assert_array_equal(ours.scans, ref.scans)
    np.testing.assert_array_equal(ours.gt_poses, ref.gt_poses)
    np.testing.assert_array_equal(ours.relative_gt(2, 1), ref.relative_gt(2, 1))


# The reg_icl_nuim evaluation at a small size: narrow blocks, 4 pairs of
# 256 points in one batch (5 scans over the orbit's 360 degrees: 72
# degrees between scans), seeded weights. The pairs are bit-equal, the
# features held as in tests/test_torch_cube_ckpt.py, the consensus
# equal; RANSAC on the reference's own samples by the rule of
# tests/test_torch_solvers.py (scores, winner, inliers; the refit's pose
# within POSE_TOL, or, on a kept set of 3 or nearly rank 1, by where it
# moves the kept points); point-to-point ICP from the reference's RANSAC pose within
# POSE_TOL. The '+picp' end result, on the pairs whose RANSAC pose is
# determined, is held against the reference's own by PICP_RRE_BOUND
# degrees and PICP_RTE_BOUND: the reference's point-to-plane iteration is
# no contraction along the room's floor and walls, and its yaw jumps by up
# to 7 degrees an iteration there (ROADMAP §3); 7 degrees about points up
# to ~0.8 from the scan's origin move it by up to 2 · 0.8 · sin(3.5°) ≈ 0.1.
PICP_RRE_BOUND, PICP_RTE_BOUND = 7.0, 0.1
ICL_SMALL = dict(num_points=256, num_pairs=4, batch_pairs=4)


def _recording(module, sink, key):
    class Recording(module.MeterRegistration):
        def update(self, errors, reg_time=0.0):
            sink[key] = {k: np.asarray(v) for k, v in errors.items()}
            super().update(errors, reg_time)
    return Recording


@pytest.fixture(scope="module")
def icl_small():
    """The reg_icl_nuim preset on both sides at ICL_SMALL, narrow blocks and
    canonical voxels, with the same seeded weights: the reference's init
    with its parameters perturbed (its BN statistics stay at 0 and 1, so
    no layer's ReLU zeroes every feature), converted."""
    rng = np.random.RandomState(0)
    cfg = get_config("reg_icl_nuim")
    cfg.model.blocks = ((16, 1, 8), (32, 1, 8), (32, 1, None))
    cfg.model.local_neighbors = 16
    cfg.model.use_new_coords_for_voxel = True
    for k, v in ICL_SMALL.items():
        setattr(cfg.evaluate, k, v)
    jcfg = j_get_config("reg_icl_nuim")
    jcfg.model = JaxModelConfig(**dataclasses.asdict(cfg.model))
    jcfg.evaluate = JaxEvalConfig(**dataclasses.asdict(cfg.evaluate))
    jax_model = j_loop.build_model(jcfg)
    variables = jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 256, 6)), train=False)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.uniform(-0.05, 0.05, np.shape(a))).astype(np.float32),
        variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    model = t_loop.build_model(cfg)
    model.load_state_dict(from_flax(params, stats))
    state = JaxTrainState(step=0, params=params, batch_stats=stats, opt_state=None)
    return cfg, jcfg, model.eval(), jax_model, state


def test_reg_icl_nuim_evaluation_matches_reference_stage_by_stage(icl_small, monkeypatch):
    cfg, jcfg, model, jax_model, state = icl_small
    ev = cfg.evaluate
    assert (ev.method, ev.pairs_mode, ev.num_hypotheses) == ("ransac+picp", "icl_nuim", 4000)
    assert (ev.noise_bound, ev.inlier_threshold) == (0.05, 0.07)
    # The pairs.
    batch = next(get_pairs(None, ev.num_points, ev.pairs_mode, ev.num_pairs).batches(4))
    jbatch = next(j_get_pairs(None, ev.num_points, ev.pairs_mode, ev.num_pairs).batches(4))
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(batch, field), getattr(jbatch, field))
    src, dst = torch.from_numpy(batch.source), torch.from_numpy(batch.target)
    b, n = src.shape[:2]

    # The 5b features (each source under its 4 LRF flips, then the
    # targets) and the consensus, as register_eval_batch and the
    # reference's evaluate_registration compute them.
    @jax.jit
    def j_features_and_matches(variables, s, d):
        clouds = jnp.concatenate([s, d], 0)
        x = jnp.concatenate([clouds, j_normals(clouds)], -1)
        basis = j_lrf_basis(clouds - clouds.mean(-2, keepdims=True), jax_model.lrf_kind)
        lrf_all = jnp.concatenate([j_lrf_flips(basis[:b]).reshape(-1, 3, 3), basis[b:]], 0)
        feats = jax_model.apply(variables, jnp.concatenate([jnp.repeat(x[:b], 4, 0), x[b:]], 0),
                                train=False, lrf=lrf_all)
        match = jax.vmap(lambda s1, d1, fs, fd: j_consensus(s1, d1, fs, fd,
                                                            tau=2.0 * ev.noise_bound))
        return feats, match(s, d, feats[:4 * b].reshape(b, 4, n, -1), feats[4 * b:])

    want_f, want_m = j_features_and_matches(
        {"params": state.params, "batch_stats": state.batch_stats},
        jnp.asarray(batch.source), jnp.asarray(batch.target))
    want_f = np.asarray(want_f)
    with torch.no_grad(), f32_geometry():
        clouds = torch.cat([src, dst], 0)
        feats = t_loop.flip_features(model, torch.cat([clouds, estimate_normals(clouds)], -1), b)
        got_m = consensus_match(src, dst, feats[:4 * b].reshape(b, 4, n, -1), feats[4 * b:],
                                tau=2.0 * ev.noise_bound)
    err = np.abs(feats.numpy() - want_f).max(-1) / np.abs(want_f).max()
    assert (err > 1e-3).mean() <= 0.01 and np.median(err) < 1e-5, (err > 1e-3).mean()
    for got, want in zip(got_m, want_m):  # i1, i2, mask, hypothesis
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # RANSAC on the reference's samples: each pair's key as the reference's
    # evaluate_registration splits it from PRNGKey(seed), its draw on the
    # consensus mask.
    _, sub = jax.random.split(jax.random.PRNGKey(cfg.seed))
    keys = jax.random.split(sub, b)
    i1, i2, mask = (x.numpy() for x in got_m[:3])
    m_src = np.take_along_axis(batch.source, i1[..., None], 1)
    m_dst = np.take_along_axis(batch.target, i2[..., None], 1)
    samples = np.stack([_ref_samples([k], v[None], ev.num_hypotheses)[0]
                        for k, v in zip(keys, mask)])
    t_ransac, inliers, score = ransac_from_samples(
        *map(torch.from_numpy, (m_src, m_dst, mask, samples)), ev.inlier_threshold,
        irls_iterations=ev.ransac_irls, irls_shrink=ev.ransac_irls_shrink)
    determined, w_ransac = [], []
    for i in range(b):
        wt, winl = j_ransac(keys[i], *map(jnp.asarray, (m_src[i], m_dst[i], mask[i])),
                            num_hypotheses=ev.num_hypotheses,
                            inlier_threshold=ev.inlier_threshold,
                            irls_iterations=ev.ransac_irls, irls_shrink=ev.ransac_irls_shrink)
        w_ransac.append(np.asarray(wt))
        winner, scores = _ref_winner(*map(jnp.asarray, (m_src[i], m_dst[i], mask[i],
                                                        samples[i])),
                                     threshold=ev.inlier_threshold)
        thin = _thin_samples(m_src[i], m_dst[i], samples[i])
        np.testing.assert_array_equal(score[i].numpy()[~thin], scores[~thin])
        if max(score[i].numpy()[thin].max(initial=-1), scores[thin].max(initial=-1)) \
                < scores.max():
            assert int(torch.argmax(score[i])) == winner
        np.testing.assert_array_equal(inliers[i].numpy(), np.asarray(winl))
        kept, kept_dst = m_src[i][np.asarray(winl)], m_dst[i][np.asarray(winl)]
        sv = np.linalg.svd((kept - kept.mean(0)).T @ (kept_dst - kept_dst.mean(0)),
                           compute_uv=False) if len(kept) else [0.0, 0.0]
        # Three kept matches are coplanar: their cross-covariance has rank 2,
        # and both packages' eigen-based rotation_from_h keeps about half
        # the digits of a rotation built on a zero singular value. Such
        # refits, like nearly rank-1 ones, are held by where they move the
        # kept points.
        determined.append(len(kept) > 3 and sv[1] >= RANK_SHARE * sv[0])
        if determined[-1]:
            np.testing.assert_allclose(t_ransac[i].numpy(), w_ransac[i], rtol=0, atol=POSE_TOL)
        else:
            def moved(t):
                return kept @ t[:3, :3].T + t[:3, 3]
            np.testing.assert_allclose(moved(t_ransac[i].numpy()), moved(w_ransac[i]), rtol=0,
                                       atol=RANK_MOVE)
    assert any(determined)

    # Point-to-point ICP (the first half of '+picp') from the reference's
    # RANSAC pose.
    w_ransac = np.stack(w_ransac)
    with torch.no_grad(), f32_geometry():
        t_icp = icp_pose(src, dst, init_transform=torch.from_numpy(w_ransac))
    w_icp = jax.vmap(lambda a, c, init: j_icp(a, c, init_transform=init))(
        jnp.asarray(batch.source), jnp.asarray(batch.target), jnp.asarray(w_ransac))
    np.testing.assert_allclose(t_icp.numpy(), np.asarray(w_icp), rtol=0, atol=POSE_TOL)

    # End to end ('ransac+picp', the preset unchanged but for its size), the
    # port drawing the reference's samples.
    drawn = []

    def given(valid, num_hypotheses, generator, sample_size=3):
        drawn.append(num_hypotheses)
        return torch.from_numpy(np.stack([_ref_samples([k], v[None], num_hypotheses)[0]
                                          for k, v in zip(keys, valid.numpy())]))

    monkeypatch.setattr(ransac_module, "ransac_samples", given)
    errors = {}
    monkeypatch.setattr(t_loop, "MeterRegistration", _recording(t_loop, errors, "port"))
    monkeypatch.setattr(j_loop, "MeterRegistration", _recording(j_loop, errors, "ref"))
    got = evaluate_registration(cfg, model=model, device="cpu")
    want = j_loop.evaluate_registration(jcfg, state=state, model=jax_model)
    assert drawn == [ev.num_hypotheses] * 2  # the warm-up and the timed batch
    assert set(got) == set(want) and all(np.isfinite(v) for v in got.values())
    g, w = errors["port"], errors["ref"]
    np.testing.assert_array_equal(g["succ"], w["succ"])
    held = np.asarray(determined)
    np.testing.assert_allclose(g["rre"][held], w["rre"][held], rtol=0, atol=PICP_RRE_BOUND)
    np.testing.assert_allclose(g["rte"][held], w["rte"][held], rtol=0, atol=PICP_RTE_BOUND)


@pytest.mark.parametrize("iterations", [3, 20])
def test_picp_on_adjacent_room_scans_matches_reference(iterations):
    """The '+picp' refiner at the preset's own spacing (100 pairs: 3.6
    degrees between scans) on the first 4 pairs of 256 points: point-to-point
    ICP from the identity within POSE_TOL of the reference's, then
    point-to-plane ICP with its 0.05 gate from that pose. After 3
    iterations within POSE_TOL; after the refiner's 20, by RRE within 0.1
    degrees and RTE within 1e-3 (the deterministic bound of
    tests/test_torch_eval.py), the floor and walls' free directions
    (ROADMAP §3) leaving room for rounding to grow."""
    src, dst, gt = (a[:4] for a in SequencePairs(num_pairs=100, num_points=256).arrays())
    s, d, g = map(torch.from_numpy, (src, dst, gt))
    with torch.no_grad(), f32_geometry():
        t_icp = icp_pose(s, d)
        t_pl = icp_plane_pose(s, d, estimate_normals(d), init_transform=t_icp,
                              max_iterations=iterations, max_correspondence_distance=0.05)
        got = pair_errors(s, g, t_pl)
        start = pair_errors(s, g, torch.eye(4).expand(4, 4, 4))
    js, jd = jnp.asarray(src), jnp.asarray(dst)
    w_icp = jax.vmap(lambda a, c: j_icp(a, c))(js, jd)
    w_pl = jax.vmap(lambda a, c, nrm, init: j_icp_plane(
        a, c, nrm, init_transform=init, max_iterations=iterations,
        max_correspondence_distance=0.05))(js, jd, j_normals(jd), w_icp)
    want = j_pair_errors(js, jnp.asarray(gt), w_pl)
    np.testing.assert_allclose(t_icp.numpy(), np.asarray(w_icp), rtol=0, atol=POSE_TOL)
    if iterations == 3:
        np.testing.assert_allclose(t_pl.numpy(), np.asarray(w_pl), rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(got["rre"].numpy(), np.asarray(want["rre"]), rtol=0, atol=0.1)
    np.testing.assert_allclose(got["rte"].numpy(), np.asarray(want["rte"]), rtol=0, atol=1e-3)
    assert bool((got["rre"] < start["rre"]).all())  # every pair moved toward its ground truth


# ---- ModelNet40 files and furthest point sampling ----

MN40_CLASSES = ("airplane", "night_stand", "cup")


def _write_modelnet40(root, rng, points: int = 300) -> None:
    """A modelnet40_normal_resampled tree: 3 classes (one with an
    underscore in its name) x 2 items, item 0 of each class in the train
    list and item 1 in the test list; rows x,y,z,nx,ny,nz."""
    (root / "modelnet40_shape_names.txt").write_text("\n".join(MN40_CLASSES) + "\n")
    train, test = [], []
    for cls in MN40_CLASSES:
        (root / cls).mkdir()
        for i in (1, 2):
            name = f"{cls}_{i:04d}"
            pts = rng.randn(points, 3)
            if i == 2:
                pts[:40] = np.round(pts[:40])  # duplicates and equal distances: FPS ties
            normals = rng.randn(points, 3)
            normals /= np.linalg.norm(normals, axis=1, keepdims=True)
            np.savetxt(root / cls / f"{name}.txt", np.concatenate([pts, normals], 1),
                       delimiter=",", fmt="%.6f")
            (train if i == 1 else test).append(name)
    (root / "modelnet40_train.txt").write_text("\n".join(train) + "\n")
    (root / "modelnet40_test.txt").write_text("\n\n".join(test) + "\n")  # blank lines skipped


@pytest.mark.parametrize("sample_method", ["random", "fps"])
def test_modelnet40_files_equal_reference(tmp_path, rng, sample_method):
    """The file loader on a tree the test writes: every split's batches
    equal rift_tpu's, from the txt files, then again from the .npy and FPS
    caches the first pass wrote (a second tree for the reference, so each
    package writes and reads its own caches), and with cache_npy off."""
    from rift_tpu.data.modelnet40 import ModelNet40 as JaxModelNet40
    from rift_tpu.data.modelnet40 import ModelNet40Config as JaxModelNet40Config
    from rift_tpu_torch.data.modelnet40 import ModelNet40, ModelNet40Config

    ours_root, ref_root = tmp_path / "ours", tmp_path / "ref"
    for root in (ours_root, ref_root):
        root.mkdir()
        _write_modelnet40(root, np.random.RandomState(0))
    kwargs = dict(num_points=128, sample_method=sample_method, num_workers=2)
    for cache_npy, passes in ((True, 2), (False, 1)):
        for _ in range(passes):
            for split in ("train", "valid", "test"):
                ours = ModelNet40(ModelNet40Config(root=str(ours_root), cache_npy=cache_npy,
                                                   **kwargs), split)
                ref = JaxModelNet40(JaxModelNet40Config(root=str(ref_root),
                                                        cache_npy=cache_npy, **kwargs), split)
                assert len(ours) == len(ref) == 3
                assert ours._items == [(str(ours_root / p[len(str(ref_root)) + 1:]), c)
                                       for p, c in ref._items]
                for seed in (0, 4):
                    got = list(ours.batches(2, seed=seed, drop_last=False))
                    want = list(ref.batches(2, seed=seed, drop_last=False))
                    assert len(got) == len(want) == 2
                    for (c1, l1), (c2, l2) in zip(got, want):
                        assert c1.shape[1:] == (128, 6)
                        np.testing.assert_array_equal(c1, c2)
                        np.testing.assert_array_equal(l1, l2)
    cached = sorted(p.name for p in (ours_root / "night_stand").iterdir())
    fps = ["night_stand_0001.txt.fps128.npy", "night_stand_0002.txt.fps128.npy"]
    assert cached == sorted(["night_stand_0001.txt", "night_stand_0001.txt.npy",
                             "night_stand_0002.txt", "night_stand_0002.txt.npy"]
                            + (fps if sample_method == "fps" else []))
    assert cached == sorted(p.name for p in (ref_root / "night_stand").iterdir())
    for name in cached:
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(ours_root / "night_stand" / name),
                                          np.load(ref_root / "night_stand" / name))


def test_modelnet40_fps_on_the_synthetic_split_and_the_hard_tier():
    """sample_method='fps' on the synthetic split, and an occluded tier
    (random sampling of the cut cloud), equal to the reference's."""
    from rift_tpu.data.modelnet40 import ModelNet40 as JaxModelNet40
    from rift_tpu.data.modelnet40 import ModelNet40Config as JaxModelNet40Config
    from rift_tpu_torch.data.modelnet40 import ModelNet40, ModelNet40Config

    for extra in ({}, {"occlusion": 0.2, "noise_sigma": 0.01}):
        kwargs = dict(num_points=96, sample_method="fps", num_workers=0,
                      synthetic_items={"train": 4, "valid": 2, "test": 2}, **extra)
        ours = ModelNet40(ModelNet40Config(**kwargs), "test")
        ref = JaxModelNet40(JaxModelNet40Config(**kwargs), "test")
        for i in range(2):
            a, b = ours.get(i, seed=3), ref.get(i, seed=3)
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1] == b[1]


def test_modelnet40_root_must_exist_and_sampling_be_known(tmp_path):
    from rift_tpu_torch.data.modelnet40 import ModelNet40, ModelNet40Config

    with pytest.raises(FileNotFoundError, match="synthetic"):
        ModelNet40(ModelNet40Config(root=str(tmp_path / "missing")), "train")
    with pytest.raises(ValueError, match="sample_method"):
        ModelNet40(ModelNet40Config(sample_method="grid"), "train")


@pytest.mark.parametrize("case", ["random", "grid_ties", "duplicates", "past_n"])
def test_furthest_point_sample_equals_reference(rng, case):
    """Indices equal to rift_tpu.ops.sampling's, and to the data loader's
    numpy order (start 0), batched over two leading axes; ties (points on
    a grid, duplicated points) go to the first maximum; past n samples the
    order goes on as the reference's does."""
    from rift_tpu.data.modelnet40 import _fps_order as j_fps_order
    from rift_tpu.ops.sampling import furthest_point_sample as j_fps
    from rift_tpu_torch.data.modelnet40 import _fps_order
    from rift_tpu_torch.ops.sampling import furthest_point_sample

    n, m = (40, 50) if case == "past_n" else (300, 120)
    x = rng.randn(2, 3, n, 3).astype(np.float32)
    if case == "grid_ties":
        x = np.round(x * 2) / 2
    elif case == "duplicates":
        x[..., n // 2:, :] = x[..., :n - n // 2, :]
    got = furthest_point_sample(torch.from_numpy(x), m)
    assert got.shape == (2, 3, m) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_fps(jnp.asarray(x), m)))
    start = furthest_point_sample(torch.from_numpy(x), m, start_idx=5)
    np.testing.assert_array_equal(start.numpy(), np.asarray(j_fps(jnp.asarray(x), m, 5)))
    flat = x.reshape(-1, n, 3)
    for b in range(flat.shape[0]):
        np.testing.assert_array_equal(_fps_order(flat[b], m), j_fps_order(flat[b], m))
        np.testing.assert_array_equal(_fps_order(flat[b], m), got.reshape(-1, m)[b, :min(m, n)])


def test_sampling_gather_and_random_choice(rng):
    from rift_tpu.ops.sampling import gather as j_gather
    from rift_tpu_torch.ops.sampling import gather, random_choice

    feats = rng.randn(2, 50, 5).astype(np.float32)
    idx = rng.randint(0, 50, (2, 7)).astype(np.int32)
    np.testing.assert_array_equal(gather(torch.from_numpy(feats), torch.from_numpy(idx)).numpy(),
                                  np.asarray(j_gather(jnp.asarray(feats), jnp.asarray(idx))))
    gen = torch.Generator().manual_seed(0)
    without = random_choice(gen, 20, 12)
    assert without.shape == (12,) and len(set(without.tolist())) == 12
    assert int(without.min()) >= 0 and int(without.max()) < 20
    again = random_choice(torch.Generator().manual_seed(0), 20, 12)
    assert torch.equal(without, again)
    repeated = random_choice(gen, 5, 30)
    assert repeated.shape == (30,) and int(repeated.max()) < 5 and len(set(repeated.tolist())) <= 5
