"""rift_tpu_torch's multi-scan mapping and method sweep against rift_tpu's
on the CPU: the SE(3) Lie maps, the pose-graph and observation Jacobians
against `jax.jacfwd`, the gated mutual NN, `optimize_pose_graph`,
`bundle_adjust`, the sequence's host steps (edges, odometry, landmarks and
their merge) bit for bit, `register_edges` with and without the motion
gate, `map_sequence` end to end on oracle features (world coordinates as
descriptors), `extract_features(_flips)`, and `evaluate_registration_sweep`
(the deterministic methods, and RANSAC on the reference's own samples).
The reference's runs are shared in module-scoped fixtures."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rift_tpu.train.loop as j_loop
import rift_tpu_torch.registration.ransac as ransac_module
import rift_tpu_torch.train.loop as t_loop
from rift_tpu.data.sequences import SequenceConfig as JSequenceConfig
from rift_tpu.data.sequences import SyntheticSequence as JSyntheticSequence
from rift_tpu.ops import neighbors as j_nb
from rift_tpu.ops import se3 as j_se3
from rift_tpu.train import get_config as j_get_config
from rift_tpu.train.config import EvalConfig as JaxEvalConfig
from rift_tpu.train.config import ModelConfig as JaxModelConfig
from rift_tpu.train.steps import TrainState as JaxTrainState
from rift_tpu_torch.data.sequences import SequenceConfig, SyntheticSequence
from rift_tpu_torch.ops import neighbors as t_nb
from rift_tpu_torch.ops import se3 as t_se3
from rift_tpu_torch.train import get_config
from rift_tpu_torch.weights import from_flax
from test_pose_graph import _make_ba_problem, _make_trajectory
from test_torch_eval import _hold, _per_pair, _recording
from test_torch_solvers import _ref_samples

# The modules (each package's `registration` exports a function named
# `bundle_adjust`, which shadows its module as an attribute).
j_ba, j_pg, j_seq, t_ba, t_pg, t_seq = (
    importlib.import_module(f"{pkg}.registration.{mod}")
    for pkg in ("rift_tpu", "rift_tpu_torch")
    for mod in ("bundle_adjust", "pose_graph", "sequence"))

# The Lie maps and Jacobians: f32 against f32, different op orders.
LIE_TOL = 2e-6
# Near π the log divides by sin θ, and the f32 rounding of cos θ moves θ
# by ~6e-8 / sin θ: at θ = π − 0.05 (NEAR_PI) both packages' logs stay
# within LIE_TOL_PI of each other (at π − 1e-3 they differ by 9%).
NEAR_PI = np.pi - 0.05
LIE_TOL_PI = 5e-4
JAC_TOL = 2e-5
# Near π the Jacobian is a sum of terms ~1/sin²θ larger than itself, so
# both packages' f32 Jacobians miss the f64 one by ~4e-3 at θ = π − 0.05:
# the port's is held within JAC_PI_RATIO times the reference's distance
# from the f64 Jacobian (the port's in f64; measured ratios up to 1.47).
JAC_PI_RATIO = 2.0
# Solves from the same inputs: poses within POSE_TOL (absolute), the
# reference's test of its sharding (tests/test_sequence.py:104-106) at 1e-3.
POSE_TOL = 1e-4
MAP_TOL = 1e-3
# Of the largest feature: tests/test_torch_model.py holds the model at
# 1e-4 on random clouds; the room's planar scans make the estimated
# normals more sensitive (measured 1.3e-4).
FEAT_TOL = 2e-4
# The motion gate's candidates at its boundary (d² = gate² up to rounding)
# may differ: at most this share of a batch's [n, n] gate.
GATE_FLIP_SHARE = 1e-3


def _np(x):
    return np.asarray(x)


def _rotations():
    """Twists at θ = 0, small, generic and near π (f32)."""
    rng = np.random.RandomState(1)
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    return {"zero": np.zeros(6, np.float32),
            "small": np.concatenate([axis * 3e-5, rng.randn(3) * 0.1]).astype(np.float32),
            "generic": np.concatenate([axis * 1.1, rng.randn(3)]).astype(np.float32),
            "near_pi": np.concatenate([axis * NEAR_PI, rng.randn(3)]).astype(np.float32)}


@pytest.mark.parametrize("case", ["zero", "small", "generic", "near_pi"])
def test_lie_maps_match_reference(case):
    xi = _rotations()[case]
    tol = LIE_TOL_PI if case == "near_pi" else LIE_TOL
    t_xi = torch.from_numpy(xi)
    t = t_se3.exp_se3(t_xi)
    np.testing.assert_allclose(t.numpy(), _np(j_se3.exp_se3(jnp.asarray(xi))), atol=LIE_TOL)
    tj = j_se3.exp_se3(jnp.asarray(xi))
    np.testing.assert_allclose(t_se3.log_se3(t).numpy(), _np(j_se3.log_se3(tj)), atol=tol)
    np.testing.assert_allclose(t_se3.log_so3(t[:3, :3]).numpy(), _np(j_se3.log_so3(tj[:3, :3])),
                               atol=tol)
    np.testing.assert_allclose(t_se3.log_se3(t).numpy(), xi, atol=tol * 10)  # round trip
    np.testing.assert_allclose(t_se3.inverse(t).numpy(), _np(j_se3.inverse(tj)), atol=LIE_TOL)
    np.testing.assert_allclose(t_se3.concatenate(t, t_se3.inverse(t)).numpy(), np.eye(4),
                               atol=LIE_TOL)
    np.testing.assert_array_equal(
        t_se3.make_se3(t[:3, :3], t[:3, 3]).numpy(),
        _np(j_se3.make_se3(jnp.asarray(t[:3, :3].numpy()), jnp.asarray(t[:3, 3].numpy()))))


def test_lie_round_trip_batched(rng):
    xi = (rng.randn(16, 6) * 0.5).astype(np.float32)
    back = t_se3.log_se3(t_se3.exp_se3(torch.from_numpy(xi))).numpy()
    np.testing.assert_allclose(back, xi, atol=1e-4)  # rift_tpu's own test's tolerance


def test_rotation_error_orthonormalize_matches_reference(rng):
    rot = _np(j_se3.exp_so3(jnp.asarray(rng.randn(6, 3).astype(np.float32))))
    est = (rot @ (np.eye(3) + 5e-3 * rng.randn(6, 3, 3))).astype(np.float32)
    for ortho in (False, True):
        got = t_se3.rotation_error_deg(torch.from_numpy(rot), torch.from_numpy(est),
                                       orthonormalize=ortho).numpy()
        want = _np(j_se3.rotation_error_deg(jnp.asarray(rot), jnp.asarray(est),
                                            orthonormalize=ortho))
        np.testing.assert_allclose(got, want, atol=0.05)


def _edge_case(case):
    """Poses and an inverse measurement of one edge whose residual sits at
    the rotation `case` (the identity when 'zero')."""
    rng = np.random.RandomState(2)
    pose_i = _np(j_se3.exp_se3(jnp.asarray((rng.randn(6) * 0.3).astype(np.float32))))
    rel = _np(j_se3.exp_se3(jnp.asarray((rng.randn(6) * 0.3).astype(np.float32))))
    pose_j = (pose_i @ rel).astype(np.float32)
    off = _np(j_se3.exp_se3(jnp.asarray(_rotations()[case])))
    meas_inv = np.linalg.inv(rel @ off).astype(np.float32)
    return pose_i[None], pose_j[None], meas_inv[None]


@pytest.mark.parametrize("case", ["zero", "small", "generic", "near_pi"])
def test_edge_jacobians_match_jax_jacfwd(case):
    """_edge_terms' residual and Jacobians at ξ = 0 against the reference's
    (jax.jacfwd), where the log's clip is active (the identity) and away."""
    args = _edge_case(case)
    got = t_pg._edge_terms(*map(torch.from_numpy, args))
    want = jax.vmap(j_pg._edge_terms)(*map(jnp.asarray, args))
    exact = t_pg._edge_terms(*(torch.from_numpy(a).double() for a in args))
    for g, w, e in zip(got, want, exact):
        assert g.dtype == torch.float32
        if case == "near_pi":
            ref_err = np.abs(_np(w) - e.numpy()).max()
            assert np.abs(g.double().numpy() - e.numpy()).max() <= JAC_PI_RATIO * ref_err
        else:
            np.testing.assert_allclose(g.numpy(), _np(w),
                                       atol=JAC_TOL * max(1.0, np.abs(_np(w)).max()))


def test_observation_jacobians_match_jax_jacfwd(rng):
    poses = _np(j_se3.exp_se3(jnp.asarray((rng.randn(8, 6) * 0.8).astype(np.float32))))
    x_l = rng.randn(8, 3).astype(np.float32)
    y = rng.randn(8, 3).astype(np.float32)
    got = t_ba._obs_terms(*map(torch.from_numpy, (poses, x_l, y)))
    want = jax.vmap(j_ba._obs_terms)(*map(jnp.asarray, (poses, x_l, y)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=JAC_TOL * np.abs(_np(w)).max())


def test_gated_mutual_nn_matches_reference(rng):
    """Batched over 3 pairs against the reference per pair; a gate of all
    True is the ungated match, rows with no candidate come back masked."""
    f1 = rng.randn(3, 40, 8).astype(np.float32)
    f2 = rng.randn(3, 36, 8).astype(np.float32)
    gate = rng.rand(3, 40, 36) < 0.5
    gate[:, :4] = False
    got = t_nb.gated_mutual_nearest_neighbors(*map(torch.from_numpy, (f1, f2, gate)))
    for i in range(3):
        want = j_nb.gated_mutual_nearest_neighbors(*map(jnp.asarray, (f1[i], f2[i], gate[i])))
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g[i].numpy(), _np(w))
    assert not got[2][:, :4].any()
    ungated = t_nb.mutual_nearest_neighbors(torch.from_numpy(f1), torch.from_numpy(f2))
    every = t_nb.gated_mutual_nearest_neighbors(torch.from_numpy(f1), torch.from_numpy(f2),
                                                torch.ones(3, 40, 36, dtype=torch.bool))
    assert torch.equal(every[1], ungated[1]) and torch.equal(every[2], ungated[2])


def _chain_init(gt, meas, n):
    init = [gt[0]]
    for k in range(n - 1):
        init.append(init[-1] @ meas[k])
    return np.stack(init).astype(np.float32)


@pytest.mark.parametrize("drift", [0.03, 0.0])
def test_optimize_pose_graph_matches_reference(drift):
    """A drifting trajectory (odometry chain, noisy loop closures) and one
    with exact measurements from perturbed poses: the port's poses within
    POSE_TOL of the reference's, its ATE too, on weighted edges."""
    rng = np.random.RandomState(0)
    n = 8
    gt, i_idx, j_idx, meas = _make_trajectory(rng, n, drift=drift)
    if drift:
        init = _chain_init(gt, meas, n)
    else:
        init = np.stack([gt[k] @ _np(j_se3.exp_se3(jnp.asarray(
            (rng.randn(6) * 0.05).astype(np.float32)))) for k in range(n)]).astype(np.float32)
        init[0] = gt[0]
    w = (0.5 + rng.rand(len(i_idx))).astype(np.float32)
    iters = 10 if drift else 15
    want = _np(j_pg.optimize_pose_graph(*map(jnp.asarray, (init, i_idx, j_idx, meas, w)),
                                        num_iterations=iters))
    got = t_pg.optimize_pose_graph(*map(torch.from_numpy, (init, i_idx, j_idx, meas, w)),
                                   num_iterations=iters).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=POSE_TOL)
    ate = float(t_pg.trajectory_ate(torch.from_numpy(gt), torch.from_numpy(got)))
    assert abs(ate - float(j_pg.trajectory_ate(jnp.asarray(gt), jnp.asarray(want)))) < POSE_TOL
    if not drift:
        assert ate < 1e-3
    else:
        assert ate < float(t_pg.trajectory_ate(torch.from_numpy(gt), torch.from_numpy(init)))


def _ba_case(variant):
    rng = np.random.RandomState(0)
    gt_poses, gt_lms, obs_pose, obs_local = _make_ba_problem(rng, noise=0.01)
    init_poses = gt_poses.copy()
    for i in range(1, len(gt_poses)):
        init_poses[i] = gt_poses[i] @ _np(j_se3.exp_se3(jnp.asarray(
            np.concatenate([rng.randn(3) * 0.02, rng.randn(3) * 0.05]).astype(np.float32))))
    init_lms = (gt_lms + rng.randn(*gt_lms.shape) * 0.05).astype(np.float32)
    obs_pose[::5, 2] = -1  # padded observations
    edges = None
    if variant == "edges":
        i_idx, j_idx = np.array([0, 1, 2, 0], np.int32), np.array([1, 2, 3, 3], np.int32)
        rel = np.stack([np.linalg.inv(gt_poses[i]) @ gt_poses[j]
                        for i, j in zip(i_idx, j_idx)]).astype(np.float32)
        edges = (i_idx, j_idx, rel, np.array([10.0, 20.0, 5.0, 1.0], np.float32))
    return (init_poses.astype(np.float32), init_lms, obs_pose, obs_local), edges


@pytest.mark.parametrize("variant, huber", [("plain", 0.05), ("plain", None), ("edges", 0.05),
                                            ("edges", None)])
def test_bundle_adjust_matches_reference(variant, huber):
    """With and without Huber, alone and joint with pose-graph edges:
    poses and landmarks within POSE_TOL of the reference's; the guard
    accepts the result in both."""
    args, edges = _ba_case(variant)
    kw = dict(num_iterations=5, huber_delta=huber)
    want = j_ba.bundle_adjust(*map(jnp.asarray, args), **kw, edges=None if edges is None
                              else tuple(map(jnp.asarray, edges)))
    got = t_ba.bundle_adjust(*map(torch.from_numpy, args), **kw, edges=None if edges is None
                             else tuple(map(torch.from_numpy, edges)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=0, atol=POSE_TOL)
    assert not np.array_equal(got[1].numpy(), args[1])
    assert not np.array_equal(_np(want[1]), args[1])


def test_bundle_adjust_guard_rejects_a_worse_result(monkeypatch):
    """The guard taken the other way: in both packages a pose step turned
    against the descent (its sign flipped, ten times longer) makes the
    cost worse, and the input comes back unchanged. (The reference's
    jitted solve is traced anew for num_iterations=3, which no other test
    of this process uses, so it sees the patched step.)"""
    args, _ = _ba_case("plain")
    for module in (t_ba, j_ba):
        solve = module._solve_poses
        monkeypatch.setattr(module, "_solve_poses",
                            lambda *a, _solve=solve, **kw: -10.0 * _solve(*a, **kw))
    got = t_ba.bundle_adjust(*map(torch.from_numpy, args), num_iterations=3)
    want = j_ba.bundle_adjust(*map(jnp.asarray, args), num_iterations=3)
    for g, w, x in zip(got, want, args):
        np.testing.assert_array_equal(g.numpy(), x)
        np.testing.assert_array_equal(_np(w), x)


@pytest.fixture(scope="module")
def oracle_seq():
    """8 scans of 128 points and their oracle features (world
    coordinates: the nearest physical point is the nearest feature)."""
    cfg = dict(num_scans=8, num_points=128, scene_points=2048, seed=4)
    seq = SyntheticSequence(SequenceConfig(**cfg))
    ref = JSyntheticSequence(JSequenceConfig(**cfg))
    np.testing.assert_array_equal(seq.scans, ref.scans)
    feats = np.stack([s @ p[:3, :3].T + p[:3, 3] for s, p in zip(seq.scans, seq.gt_poses)])
    return seq, feats.astype(np.float32)


MAP_KW = dict(noise_bound=0.08, loop_stride=4, landmarks_per_edge=16, batch_edges=8, seed=0)


@pytest.fixture(scope="module")
def maps(oracle_seq):
    seq, feats = oracle_seq
    want = j_seq.map_sequence(seq.scans, feats, gt_poses=seq.gt_poses, **MAP_KW)
    got = t_seq.map_sequence(seq.scans, feats, gt_poses=seq.gt_poses, device="cpu", **MAP_KW)
    return got, want


def test_map_sequence_matches_reference_on_oracle_features(maps):
    """The whole pipeline (registration, the gated round, pose graph,
    landmarks, joint BA): measurements, graph and BA poses within MAP_TOL,
    every ATE within MAP_TOL, the same edges and metric keys."""
    got, want = maps
    assert list(got.metrics) == list(want.metrics)
    for k in ("measurements", "odometry", "graph", "ba"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=0, atol=MAP_TOL,
                                   err_msg=k)
    for a, b in zip(got.edges, want.edges):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.edge_weights, want.edge_weights)
    for k in ("ate_odometry", "ate_graph", "ate_ba"):
        assert abs(got.metrics[k] - want.metrics[k]) < MAP_TOL, k
    assert got.metrics["ate_ba"] < 0.05 and got.metrics["mean_edge_inliers"] > 0.2
    assert set(got.seconds) >= {"register", "refresh", "pose graph", "landmarks",
                                "bundle adjustment"}


def test_map_sequence_dumps_the_trajectories(oracle_seq, tmp_path, monkeypatch):
    seq, feats = oracle_seq
    path = tmp_path / "map.npz"
    monkeypatch.setenv("RIFT_MAP_DUMP", str(path))
    res = t_seq.map_sequence(seq.scans, feats, gt_poses=seq.gt_poses, device="cpu",
                             gate_rounds=0, **MAP_KW)
    dump = np.load(path)
    assert set(dump.files) == {"measurements", "i_idx", "j_idx", "edge_w", "odom", "graph",
                               "ba", "gt"}
    np.testing.assert_array_equal(dump["ba"], res.ba)


def test_host_steps_are_bit_equal_to_the_reference(maps, oracle_seq):
    """build_edges, odometry_from_measurements, build_landmarks and
    merge_landmarks on the reference's own inputs (its measurements,
    matches and graph): bit-equal."""
    seq, _ = oracle_seq
    _, want = maps
    for t, s in ((24, 6), (10, 4), (5, 0), (96, 6)):
        for a, b in zip(t_seq.build_edges(t, s), j_seq.build_edges(t, s)):
            np.testing.assert_array_equal(a, b)
    i_idx, j_idx = want.edges
    np.testing.assert_array_equal(
        t_seq.odometry_from_measurements(8, i_idx, j_idx, want.measurements),
        j_seq.odometry_from_measurements(8, i_idx, j_idx, want.measurements))
    c_idx, c_w, _ = j_seq.refresh_correspondences(jnp.asarray(seq.scans), i_idx, j_idx,
                                                  want.measurements, 0.24, batch_edges=8)
    c_idx, c_w = np.asarray(c_idx), np.asarray(c_w)
    kw = dict(per_edge=16, max_residual=0.24, min_edge_inliers=0.05)
    got = t_seq.build_landmarks(seq.scans, want.graph, i_idx, j_idx, c_idx, c_w,
                                want.measurements, **kw)
    ref = j_seq.build_landmarks(seq.scans, want.graph, i_idx, j_idx, c_idx, c_w,
                                want.measurements, **kw)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert (got[1] >= 0).any()
    for voxel in (0.24, 0.05):
        for a, b in zip(t_seq.merge_landmarks(*ref, voxel), j_seq.merge_landmarks(*ref, voxel)):
            np.testing.assert_array_equal(a, b)
    empty = (np.zeros((2, 3), np.float32), -np.ones((2, 2), np.int32),
             np.zeros((2, 2, 3), np.float32))
    for a, b in zip(t_seq.merge_landmarks(*empty, 0.05), empty):
        np.testing.assert_array_equal(a, b)


def test_refresh_correspondences_matches_reference(maps, oracle_seq):
    seq, _ = oracle_seq
    _, want = maps
    i_idx, j_idx = want.edges
    got = t_seq.refresh_correspondences(torch.from_numpy(seq.scans), i_idx, j_idx,
                                        want.measurements, 0.24, batch_edges=8)
    ref = j_seq.refresh_correspondences(jnp.asarray(seq.scans), i_idx, j_idx,
                                        want.measurements, 0.24, batch_edges=8)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("gated", [False, True])
def test_register_edges_matches_reference(oracle_seq, gated):
    """TEASER on the oracle features of every edge, ungated and inside a
    0.3 gate around the ground-truth priors: the same matches, inlier
    weights and transforms within MAP_TOL. At the gate's boundary the
    candidate sets may differ by rounding (at most GATE_FLIP_SHARE)."""
    seq, feats = oracle_seq
    i_idx, j_idx = t_seq.build_edges(8, 4)
    kw = dict(method="teaserpp", noise_bound=0.08, batch_edges=8, seed=0)
    if gated:
        priors = np.stack([seq.relative_gt(int(a), int(b)) for a, b in zip(i_idx, j_idx)])
        kw.update(priors=priors, spatial_gate=0.3)
        s_prior = np.einsum("enj,eij->eni", seq.scans[i_idx], priors[:, :3, :3]) \
            + priors[:, None, :3, 3]
        d2 = ((s_prior[:, :, None] - seq.scans[j_idx][:, None]) ** 2).sum(-1)
        assert np.mean(np.abs(d2 - 0.09) < 1e-6) < GATE_FLIP_SHARE
    got = t_seq.register_edges(torch.from_numpy(seq.scans), torch.from_numpy(feats),
                               i_idx, j_idx, **kw)
    want = j_seq.register_edges(jnp.asarray(seq.scans), jnp.asarray(feats), i_idx, j_idx, **kw)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=MAP_TOL)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])


def _tiny_pair_models(rng, flips: bool = True):
    """tiny_smoke as a feature extractor in both packages with the same
    perturbed weights: (cfg, jcfg, model, jax_model, jax state)."""
    cfg = get_config("tiny_smoke")
    cfg.model.is_classify = False
    cfg.evaluate.flip_hypotheses = flips
    jcfg = j_get_config("tiny_smoke")
    jcfg.model = JaxModelConfig(**dataclasses.asdict(cfg.model))
    jcfg.evaluate = JaxEvalConfig(**dataclasses.asdict(cfg.evaluate))
    jax_model = j_loop.build_model(jcfg)
    variables = jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 6)), train=False)
    perturb = lambda tree, lo, hi: jax.tree_util.tree_map(  # noqa: E731
        lambda a: (np.asarray(a) + rng.uniform(lo, hi, np.shape(a))).astype(np.float32), tree)
    params = perturb(variables["params"], -0.05, 0.05)
    stats = perturb(variables["batch_stats"], 0.1, 0.5)
    model = t_loop.build_model(cfg)
    model.load_state_dict(from_flax(params, stats))
    state = JaxTrainState(step=0, params=params, batch_stats=stats, opt_state=None)
    return cfg, jcfg, model.eval(), jax_model, state


def test_extract_features_match_reference(rng):
    """extract_features and extract_features_flips of 5 scans (a padded
    tail chunk) against the reference's: within FEAT_TOL of the largest
    feature; slot 0 of the flips is the plain features."""
    _, _, model, jax_model, state = _tiny_pair_models(rng)
    clouds = SyntheticSequence(SequenceConfig(num_scans=5, num_points=128,
                                              scene_points=2048)).scans
    got = t_loop.extract_features(model, clouds, batch_size=2).numpy()
    want = j_loop.extract_features(state, jax_model, clouds, batch_size=2)
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_TOL * np.abs(want).max())
    got_h = t_loop.extract_features_flips(model, clouds, batch_size=2).numpy()
    want_h = j_loop.extract_features_flips(state, jax_model, clouds, batch_size=2)
    assert got_h.shape == want_h.shape == (5, 4, 128, got.shape[-1])
    np.testing.assert_allclose(got_h, want_h, rtol=0, atol=FEAT_TOL * np.abs(want_h).max())
    np.testing.assert_allclose(got_h[:, 0], got, rtol=0, atol=FEAT_TOL * np.abs(got).max())


SWEEP = ["teaserpp", "fgr", "teaserpp+icp", "ransac"]


def test_evaluate_registration_sweep_matches_reference(rng, monkeypatch):
    """The sweep of tiny_smoke (flips) on 3 pairs of 128 points, 2 a batch:
    the deterministic methods and RANSAC, which draws the reference's own
    samples of each batch's keys, every method on one matching pass; per
    pair and per method the `_hold` rule of tests/test_torch_eval.py."""
    cfg, jcfg, model, jax_model, state = _tiny_pair_models(rng)
    for c in (cfg, jcfg):
        c.evaluate.num_points, c.evaluate.num_pairs, c.evaluate.batch_pairs = 128, 3, 2
        c.evaluate.num_hypotheses = 64
    key = jax.random.PRNGKey(cfg.seed)
    batch_keys = []
    for _ in range(2):
        key, sub = jax.random.split(key)
        batch_keys.append(jax.random.split(sub, 2))
    calls = []

    def given(valid, k, generator, sample_size=3):
        batch = max(len(calls) - 1, 0)  # the warm-up draws batch 0's samples too
        calls.append(k)
        return torch.from_numpy(_ref_samples(batch_keys[batch], valid.numpy(), k))

    monkeypatch.setattr(ransac_module, "ransac_samples", given)
    got, want = [], []
    monkeypatch.setattr(t_loop, "MeterRegistration", _recording(t_loop, got))
    monkeypatch.setattr(j_loop, "MeterRegistration", _recording(j_loop, want))
    t_res = t_loop.evaluate_registration_sweep(cfg, SWEEP, model=model, device="cpu")
    j_res = j_loop.evaluate_registration_sweep(jcfg, SWEEP, state=state, model=jax_model)
    assert calls == [64] * 3 and list(t_res) == SWEEP
    # The meters of each run were made in SWEEP's order; each one's batches.
    per_t = {m: _per_pair(got[i::len(SWEEP)]) for i, m in enumerate(SWEEP)}
    per_j = {m: _per_pair(want[i::len(SWEEP)]) for i, m in enumerate(SWEEP)}
    for m in SWEEP:
        _hold(t_res[m], per_t[m], j_res[m], per_j[m], 3)


def test_sweep_of_one_method_is_evaluate_registration(rng):
    """A sweep of one method draws what evaluate_registration draws: the
    same per-pair errors for 'ransac' on the same model."""
    cfg, _, model, _, _ = _tiny_pair_models(rng)
    cfg.evaluate.num_points, cfg.evaluate.num_pairs, cfg.evaluate.batch_pairs = 128, 3, 2
    cfg.evaluate.method, cfg.evaluate.num_hypotheses = "ransac", 64
    sweep = t_loop.evaluate_registration_sweep(cfg, ["ransac"], model=model, device="cpu")
    plain = t_loop.evaluate_registration(cfg, model=model, device="cpu")
    for k in ("rre", "rte", "rmse", "succ", "rmse_succ"):
        assert sweep["ransac"][k] == plain[k], k
    with pytest.raises(ValueError, match="unknown method"):
        t_loop.evaluate_registration_sweep(cfg, ["ransac", "svd"], model=model, device="cpu")
