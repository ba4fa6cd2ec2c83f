"""rift_tpu_torch's registration stage against rift_tpu's: weighted Kabsch,
GNC-TLS, pair errors, the copied synthetic pairs, and register_batch end to
end on two small pairs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rift_tpu.data.registration_pairs import SyntheticPairs as JaxPairs
from rift_tpu.models import PVCNNClassifier as JaxPVCNN
from rift_tpu.ops.neighbors import mutual_nearest_neighbors as j_mnn
from rift_tpu.ops.normals import estimate_normals as j_normals
from rift_tpu.registration import gnc_pose as j_gnc
from rift_tpu.registration.kabsch import rotation_from_h as j_rot_from_h
from rift_tpu.registration.kabsch import weighted_kabsch as j_kabsch
from rift_tpu.registration.metrics import pair_errors as j_pair_errors
from rift_tpu_torch import tracing
from rift_tpu_torch.data import SyntheticPairs
from rift_tpu_torch.models import PVCNNClassifier
from rift_tpu_torch.ops.precision import f32_geometry
from rift_tpu_torch.registration import gnc
from rift_tpu_torch.registration import (gnc_pose, pair_errors, register_batch,
                                         rotation_from_h, weighted_kabsch)
from rift_tpu_torch.weights import from_flax


def _rot(rng):
    q = rng.randn(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _matches(rng, b, n, outliers):
    src = rng.uniform(-1, 1, (b, n, 3))
    dst = np.empty_like(src)
    for i in range(b):
        dst[i] = src[i] @ _rot(rng).T + rng.uniform(-0.5, 0.5, 3)
    dst += 0.005 * rng.randn(*dst.shape)
    bad = rng.rand(b, n) < outliers
    dst[bad] = rng.uniform(-1.5, 1.5, (int(bad.sum()), 3))
    valid = rng.rand(b, n) > 0.1
    return src.astype(np.float32), dst.astype(np.float32), valid


def test_weighted_kabsch_matches_reference(rng):
    src, dst, _ = _matches(rng, 3, 64, 0.0)
    w = rng.rand(3, 64).astype(np.float32)
    w[2] = 0.0  # zero total weight -> identity
    got = weighted_kabsch(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w))
    want = np.asarray(j_kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.eye(4))


def test_rotation_from_h_degenerate_cases(rng):
    h = np.zeros((3, 3, 3), np.float32)
    h[1] = np.outer([1.0, 2.0, 0.5], [0.3, -1.0, 2.0])     # rank 1
    h[2] = rng.randn(3, 3)
    got = rotation_from_h(torch.from_numpy(h)).numpy()
    want = np.asarray(j_rot_from_h(jnp.asarray(h)))
    np.testing.assert_allclose(got[2], want[2], atol=1e-5)
    np.testing.assert_array_equal(got[0], np.eye(3))  # H = 0: identity
    # Rank 1: any rotation that maps the row direction onto the column
    # direction is optimal; the two pick different ones by rounding in the
    # degenerate eigenspace. Check the optimum and that R is a rotation.
    np.testing.assert_allclose(np.trace(got[1].T @ h[1]), np.trace(want[1].T @ h[1]),
                               rtol=1e-5)
    np.testing.assert_allclose(got[1] @ got[1].T, np.eye(3), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(got[1]), 1.0, atol=1e-5)


def test_gnc_pose_matches_reference(rng):
    src, dst, valid = _matches(rng, 4, 128, 0.3)
    t, w = gnc_pose(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(valid),
                    noise_bound=0.02)
    wt, ww = jax.vmap(lambda s, d, v: j_gnc(s, d, v, noise_bound=0.02))(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid))
    # Same iteration from the same start; Kabsch rounds differently, so a
    # weight on the TLS band edge could flip — none does on these inputs.
    np.testing.assert_allclose(t.numpy(), np.asarray(wt), atol=1e-4)
    np.testing.assert_allclose(w.numpy(), np.asarray(ww), atol=1e-4)
    inliers = np.asarray(ww) > 0.5
    assert inliers.sum() > 0.5 * valid.sum()


def test_gnc_pose_fixed_schedule_matches_reference(rng):
    """early_exit=False, the fixed-length schedule, against the reference's
    lax.scan schedule under vmap by test_gnc_pose_matches_reference's
    rules, and bit-equal to the port's early-exit schedule."""
    src, dst, valid = _matches(rng, 4, 128, 0.3)
    args = tuple(map(torch.from_numpy, (src, dst, valid)))
    t, w = gnc_pose(*args, noise_bound=0.02, early_exit=False)
    wt, ww = jax.vmap(lambda s, d, v: j_gnc(s, d, v, noise_bound=0.02, early_exit=False))(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid))
    np.testing.assert_allclose(t.numpy(), np.asarray(wt), atol=1e-4)
    np.testing.assert_allclose(w.numpy(), np.asarray(ww), atol=1e-4)
    inliers = np.asarray(ww) > 0.5
    assert inliers.sum() > 0.5 * valid.sum()
    t_exit, w_exit = gnc_pose(*args, noise_bound=0.02)
    assert torch.equal(t, t_exit) and torch.equal(w, w_exit)


@pytest.mark.parametrize("start", ["kabsch", "teaser"])
@pytest.mark.parametrize("outliers", [0.3, 0.6, 0.9, 0.97])
@pytest.mark.parametrize("max_iterations", [100, 7])
def test_gnc_pose_schedules_are_bit_equal(outliers, max_iterations, start):
    """Past its fixed point a pair's iterations repeat it bit for bit, so
    the fixed-length schedule ends where the early exit stops, up to 97%
    outliers (where GNC ends on a few inliers); cut at 7 iterations both
    run all 7. Kind "gm" ignores the flag. From the plain Kabsch on the
    valid set, and as TEASER's polish: from `_tim_pose`'s estimate on the
    degree core's kept set."""
    rng = np.random.RandomState(int(outliers * 100) + max_iterations)
    src, dst, valid = map(torch.from_numpy, _matches(rng, 3, 256, outliers))
    kw = {}
    if start == "teaser":
        valid, deg = gnc.compatibility_core(src, dst, valid, 0.02)
        kw["init_transform"] = gnc._tim_pose(src, dst, valid, deg, 0.02)
    for kind in ("tls", "gm"):
        t, w = gnc_pose(src, dst, valid, max_iterations=max_iterations, kind=kind,
                        early_exit=False, **kw)
        t_exit, w_exit = gnc_pose(src, dst, valid, max_iterations=max_iterations, kind=kind,
                                  **kw)
        assert torch.equal(t, t_exit) and torch.equal(w, w_exit), kind
        assert bool(torch.isfinite(t).all())


@pytest.mark.parametrize("outliers", [0.3, 0.6, 0.9, 0.97])
def test_teaser_pose_equals_the_early_exit_polish(outliers):
    """`teaser_pose`, whose polish runs TLS's fixed 100 iterations (the
    body a card captures), gives the reference's route bit for bit in
    transforms and weights: `_tim_pose`'s estimate polished by
    `gnc_pose`'s early exit. It counts the 100 iterations, no host read
    and, on the CPU, no graph."""
    rng = np.random.RandomState(int(outliers * 100))
    src, dst, valid = map(torch.from_numpy, _matches(rng, 4, 256, outliers))
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        t, w = gnc.teaser_pose(src, dst, valid)
    counters = tracing.snapshot()["counters"]
    tracing.reset()
    assert counters == {"gnc.iterations": 100}, counters
    with f32_geometry():
        keep, deg = gnc.compatibility_core(src, dst, valid, 0.02)
        init = gnc._tim_pose(src, dst, keep, deg, 0.02)
        t_exit, w_exit = gnc_pose(src, dst, keep, init_transform=init)
    assert torch.equal(t, t_exit) and torch.equal(w, w_exit)
    assert bool(torch.isfinite(t).all())


def test_gnc_pose_fixed_schedule_reads_nothing_on_the_host(rng, monkeypatch):
    """The fixed-length schedule takes no bool() or item() of a tensor (a
    host sync on the card); the early exit tests its active pairs so."""
    src, dst, valid = _matches(rng, 2, 64, 0.3)
    args = tuple(map(torch.from_numpy, (src, dst, valid)))

    def refuse(*_):
        raise AssertionError("read on the host")

    monkeypatch.setattr(torch.Tensor, "__bool__", refuse)
    monkeypatch.setattr(torch.Tensor, "item", refuse)
    t, _ = gnc_pose(*args, early_exit=False)
    assert t.shape == (2, 4, 4)
    with pytest.raises(AssertionError, match="host"):
        gnc_pose(*args)


OFF_GRAPH = {"cpu": {}, "grad": {}, "early_exit": {"early_exit": True}, "gm": {"kind": "gm"}}


@pytest.mark.parametrize("case", OFF_GRAPH)
def test_gnc_pose_off_the_graph_path_runs_the_eager_loop(rng, case):
    """Where no captured graph may replay (the CPU, autograd on, the early
    exit, kind "gm"), gnc_pose counts no graph capture or replay inside a
    traced window, and gives the eager loop's result bit for bit (the
    early exit's is the fixed schedule's)."""
    src, dst, valid = map(torch.from_numpy, _matches(rng, 3, 128, 0.3))
    kw = {"early_exit": False, **OFF_GRAPH[case]}
    tracing.reset()
    with torch.set_grad_enabled(case == "grad"), profile(activities=[ProfilerActivity.CPU]):
        t, w = gnc_pose(src, dst, valid, **kw)
    counters = tracing.snapshot()["counters"]
    tracing.reset()
    assert "gnc.graph_captures" not in counters and "gnc.graph_replays" not in counters
    v, c2 = valid.to(src.dtype), 0.02 * 0.02
    if case == "gm":
        want = gnc._gm_loop(weighted_kabsch(src, dst, v), src, dst, v, c2, 1.4, 100)
    else:
        want = gnc._tls_fixed(src, dst, v, c2, 1.4, 100)
        assert counters["gnc.iterations"] <= 100
    assert torch.equal(t, want[0]) and torch.equal(w, want[1])


def _graph_key(shape=(4, 64), dtype=torch.float32, noise_bound=0.02, gnc_factor=1.4,
               iterations=100, tf32=False, fn=gnc._tls_fixed):
    src = torch.zeros(shape + (3,), dtype=dtype)
    valid = torch.zeros(shape, dtype=dtype)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return gnc._graph_key(fn, (src, src, valid), noise_bound, gnc_factor, iterations)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("change", [{"shape": (8, 64)}, {"shape": (4, 128)},
                                    {"dtype": torch.float64}, {"noise_bound": 0.04},
                                    {"gnc_factor": 1.3}, {"iterations": 7}, {"tf32": True},
                                    {"fn": gnc._teaser_fixed}],
                         ids=["b", "n", "dtype", "noise_bound", "gnc_factor", "iterations",
                              "tf32", "fn"])
def test_graph_key_separates_what_a_capture_depends_on(change):
    assert _graph_key() == _graph_key()
    assert _graph_key(**change) != _graph_key()


def test_graph_cache_keeps_its_bound_and_drops_the_least_recently_used():
    assert gnc._GRAPHS.size == gnc.GRAPHS_KEPT == 4
    cache, made = gnc._Bounded(gnc.GRAPHS_KEPT), []

    def make(key):
        return lambda: made.append(key) or f"graph {key}"

    for key in range(6):
        assert cache.get(key, make(key)) == f"graph {key}"
    assert list(cache.entries) == [2, 3, 4, 5]
    assert cache.get(2, make(2)) == "graph 2" and made == list(range(6))  # a hit makes nothing
    cache.get(6, make(6))
    assert list(cache.entries) == [4, 5, 2, 6]


def test_register_batch_fixed_gnc_schedule_gives_the_same_transforms():
    model = PVCNNClassifier(blocks=((8, 1, 4), (16, 1, None)), local_neighbors=8,
                            is_classify=False).eval()
    src, dst, _ = SyntheticPairs(num_pairs=2, num_points=128, seed=3).arrays()
    want = register_batch(model, src, dst, device="cpu")
    got = register_batch(model, src, dst, device="cpu", early_exit=False)
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())


def test_pair_errors_matches_reference(rng):
    pts = rng.randn(3, 50, 3).astype(np.float32)
    gt = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    est = gt.copy()
    est[1, :3, :3] = _rot(rng)
    est[2, :3, 3] = [0.001, 0.0, 0.002]
    got = pair_errors(*map(torch.from_numpy, (pts, gt, est)))
    want = j_pair_errors(*map(jnp.asarray, (pts, gt, est)))
    for key in ("rre", "rte", "rmse", "succ", "rmse_succ"):
        # The arccos of a trace next to 1 turns an ulp into ~0.03 deg.
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=0.05)
    assert got["succ"].tolist() == [1.0, 0.0, 1.0]


@pytest.mark.parametrize("mode", ["noise", "clean"])
def test_synthetic_pairs_copy_gives_the_same_arrays(mode):
    ours = SyntheticPairs(num_pairs=3, num_points=128, mode=mode, seed=2)
    ref = JaxPairs(num_pairs=3, num_points=128, mode=mode, seed=2)
    for i in range(3):
        for a, b in zip(ours[i], ref[i]):
            np.testing.assert_array_equal(a, b)
    src, dst, t = ours.arrays()
    assert src.shape == dst.shape == (3, 128, 3) and t.shape == (3, 4, 4)


BENCH_SMALL = dict(blocks=((16, 1, 8), (32, 1, 8), (32, 1, None)), dim_k=32, is_classify=False,
                   point_kernel_formal="dgcnn_kernel", voxel_shape="spherical",
                   lrf_kind="reference", extra_feature_channels=4, local_neighbors=32,
                   with_coeff=True, with_se=True, dtype="bfloat16")


def test_register_batch_matches_reference_pipeline(rng):
    cfg = dict(blocks=((16, 1, 8), (32, 1, None)), dim_k=32, is_classify=False,
               point_kernel_formal="pointnet_kernel", voxel_shape="spherical",
               lrf_kind="pca", local_neighbors=16)
    src, gt, got_t, want_t, got_idx, got_mask, want_idx, want_mask = \
        _register_against_reference(rng, cfg)
    agree = (got_mask == want_mask).mean(-1)
    assert agree.min() >= 0.99, agree
    for i in range(2):
        if agree[i] == 1.0:  # same matches: the same pose up to rounding
            np.testing.assert_allclose(got_t[i], want_t[i], atol=1e-3)
    errs = pair_errors(torch.from_numpy(src), torch.from_numpy(gt), torch.from_numpy(got_t))
    assert float(errs["rre"].max()) < 1.0, errs


def test_register_batch_of_bench_model_in_bf16_matches_reference_pipeline(rng):
    """bench.py's own model (dgcnn, global PPF, reference LRF, bf16) at
    small widths, n = 256 and k = 32 (the reference's bf16 eval local-PPF
    path, see test_torch_model)."""
    src, gt, got_t, want_t, got_idx, got_mask, want_idx, want_mask = \
        _register_against_reference(rng, BENCH_SMALL)
    # bf16 rounding alone moves about 4% of the mutual-NN decisions of this
    # random-weight model, whose matches are mostly near-ties: the
    # reference's own bf16 run agrees with its f32 run on 0.957 and 0.984
    # of the points here. Hold the port to 0.9 against the reference's bf16.
    agree = (got_mask == want_mask).mean(-1)
    assert agree.min() >= 0.9, agree
    # The true match of point i is point i (dst is a moved copy of src):
    # both find the same number of them, within 2.
    truth = np.arange(src.shape[1])
    right_got = ((got_idx == truth) & got_mask).sum(-1)
    right_want = ((want_idx == truth) & want_mask).sum(-1)
    assert np.abs(right_got - right_want).max() <= 2, (right_got, right_want)
    # Where the reference recovers the pose (within 1 degree), so does the
    # port; random weights leave one of the two pairs with a single true
    # match, which determines no pose on either side.
    rre = [pair_errors(torch.from_numpy(src), torch.from_numpy(gt),
                       torch.from_numpy(t))["rre"].numpy() for t in (got_t, want_t)]
    determined = rre[1] < 1.0
    assert determined.any() and np.all(rre[0][determined] < 1.0), rre


def _register_against_reference(rng, cfg):
    """register_batch and bench.py's composition in JAX on 2 pairs whose
    targets are moved copies of the sources: (src, gt, port poses,
    reference poses, port matches and mutual-NN masks, reference ones)."""
    # Targets are exactly moved copies of the sources, so true matches exist
    # and the pose is well determined even with random weights; resampled
    # pairs leave a random-weight model a handful of inliers, where GNC's
    # fixed point is decided by rounding.
    src, _, _ = SyntheticPairs(num_pairs=2, num_points=256, seed=0).arrays()
    gt = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    for i in range(2):
        gt[i, :3, :3] = _rot(rng)
        gt[i, :3, 3] = rng.uniform(-0.5, 0.5, 3)
    dst = (np.einsum("bij,bnj->bni", gt[:, :3, :3], src) + gt[:, None, :3, 3]).astype(np.float32)
    jax_model = JaxPVCNN(**cfg)
    variables = jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 256, 6)), train=False)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])

    # The reference composition of bench.py:register_batch.
    clouds = jnp.concatenate([jnp.asarray(src), jnp.asarray(dst)], 0)
    x = jnp.concatenate([clouds, j_normals(clouds, impl="xla")], -1)
    feats = jax_model.apply({"params": params, "batch_stats": stats}, x, train=False)
    want_t, want_idx, want_mask = [], [], []
    for i in range(2):
        i1, i2, mask = j_mnn(feats[i], feats[2 + i])
        t, _ = j_gnc(jnp.asarray(src[i])[i1], jnp.asarray(dst[i])[i2], mask, noise_bound=0.02)
        want_t.append(np.asarray(t))
        want_idx.append(np.asarray(i2))
        want_mask.append(np.asarray(mask))

    model = PVCNNClassifier(**cfg)
    model.load_state_dict(from_flax(params, stats))
    got_t = register_batch(model.eval(), src, dst, device="cpu").numpy()
    from rift_tpu_torch.ops.neighbors import mutual_nearest_neighbors
    from rift_tpu_torch.ops.normals import estimate_normals
    with torch.no_grad():
        c = torch.from_numpy(np.concatenate([src, dst], 0))
        f = model(torch.cat([c, estimate_normals(c)], -1))
        _, got_idx, got_mask = mutual_nearest_neighbors(f[:2], f[2:])
    assert np.isfinite(got_t).all() and got_t.shape == (2, 4, 4)
    return (src, gt, got_t, np.stack(want_t), got_idx.numpy(), got_mask.numpy(),
            np.stack(want_idx), np.stack(want_mask))


# --- The flagship's evaluation solvers: flip hypotheses, consensus, TEASER.

def test_lrf_flip_hypotheses_bit_equal(rng):
    from rift_tpu.ops.lrf import lrf_flip_hypotheses as j_flips
    from rift_tpu_torch.ops.lrf import lrf_flip_hypotheses

    basis = rng.randn(5, 3, 3).astype(np.float32)
    got = lrf_flip_hypotheses(torch.from_numpy(basis)).numpy()
    want = np.asarray(j_flips(jnp.asarray(basis)))
    assert got.shape == want.shape == (5, 4, 3, 3)
    np.testing.assert_array_equal(got, want)
    # Each hypothesis of a rotation is a rotation.
    rot = np.stack([_rot(rng) for _ in range(2)]).astype(np.float32)
    dets = np.linalg.det(lrf_flip_hypotheses(torch.from_numpy(rot)).numpy().astype(np.float64))
    np.testing.assert_allclose(dets, 1.0, atol=1e-5)


def _rigid_set(rng, b, n, inliers, noise=0.003):
    """b pairs of n matched points, the first `inliers` a rigid motion of
    the source plus noise, the rest uniform outliers; (src, dst, gt)."""
    src = rng.randn(b, n, 3).astype(np.float32)
    gt = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    dst = np.empty_like(src)
    for i in range(b):
        gt[i, :3, :3] = _rot(rng)
        gt[i, :3, 3] = rng.uniform(-0.5, 0.5, 3)
        dst[i] = src[i] @ gt[i, :3, :3].T + gt[i, :3, 3] + noise * rng.randn(n, 3)
        dst[i, inliers:] = rng.uniform(-2.5, 2.5, (n - inliers, 3))
    return src, dst.astype(np.float32), gt


SEPARATED = 1e-6


def _boundary_margin(src, dst, bound):
    """Smallest |‖s_i − s_j‖ − ‖d_i − d_j‖ − bound| over all pairs, in f64:
    how far every compatibility decision is from its threshold. The tests
    ask for SEPARATED = 1e-6, about 8 f32 ulps of a distance of 4, well
    above the rounding of either framework's distances."""
    def pd(x):
        x = x.astype(np.float64)
        return np.linalg.norm(x[..., :, None, :] - x[..., None, :, :], axis=-1)
    return float(np.abs(np.abs(pd(src) - pd(dst)) - bound).min())


def test_rigidity_score_matches_reference(rng):
    from rift_tpu.registration.consensus import rigidity_score as j_score
    from rift_tpu_torch.registration import rigidity_score

    b, n, tau = 3, 96, 0.04
    src, dst, _ = _rigid_set(rng, b, n, 60)
    i1 = np.stack([rng.permutation(n) for _ in range(b)])
    i2 = np.stack([rng.permutation(n) for _ in range(b)])
    i2[:, :48] = i1[:, :48]  # half the matches true
    mask = rng.rand(b, n) > 0.2
    p = np.take_along_axis(src, i1[..., None], 1)
    q = np.take_along_axis(dst, i2[..., None], 1)
    # No pair sits within SEPARATED of tau: the counts are decided away
    # from rounding, so they must be equal.
    assert _boundary_margin(p, q, tau) > SEPARATED
    got = rigidity_score(*map(torch.from_numpy, (src, dst, i1, i2, mask)), tau)
    want = [int(j_score(jnp.asarray(src[i]), jnp.asarray(dst[i]), jnp.asarray(i1[i]),
                        jnp.asarray(i2[i]), jnp.asarray(mask[i]), tau)) for i in range(b)]
    assert got.tolist() == want and min(want) > 0


def test_consensus_match_matches_reference(rng):
    """Features of 4 hypotheses of which one (a different one per pair)
    matches the target: the same matches, masks and hypothesis, without
    and with a spatial gate."""
    from rift_tpu.registration.consensus import consensus_match as j_consensus
    from rift_tpu_torch.registration import consensus_match

    b, n, c, tau = 3, 80, 16, 0.04
    src, dst, _ = _rigid_set(rng, b, n, n)
    feat_dst = rng.randn(b, n, c).astype(np.float32)
    feat_src_h = rng.randn(b, 4, n, c).astype(np.float32)
    for i, h in enumerate((2, 0, 3)):
        feat_src_h[i, h] = feat_dst[i] + 0.3 * rng.randn(n, c)
        # Another hypothesis with half the true matches.
        feat_src_h[i, (h + 1) % 4, : n // 2] = feat_dst[i, : n // 2] + 0.3 * rng.randn(n // 2, c)
    got = consensus_match(*map(torch.from_numpy, (src, dst, feat_src_h, feat_dst)), tau=tau)
    for i, h in enumerate((2, 0, 3)):
        want = j_consensus(jnp.asarray(src[i]), jnp.asarray(dst[i]),
                           jnp.asarray(feat_src_h[i]), jnp.asarray(feat_dst[i]), tau=tau)
        assert int(want[3]) == int(got[3][i]) == h
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
    # A motion-prior gate (the sequence's re-registration), some rows with
    # no allowed candidate: the same matches, masks and hypothesis.
    gate = rng.rand(b, n, n) < 0.6
    gate[:, :3] = False
    got = consensus_match(*map(torch.from_numpy, (src, dst, feat_src_h, feat_dst)), tau=tau,
                          spatial_valid=torch.from_numpy(gate))
    for i in range(b):
        want = j_consensus(jnp.asarray(src[i]), jnp.asarray(dst[i]),
                           jnp.asarray(feat_src_h[i]), jnp.asarray(feat_dst[i]), tau=tau,
                           spatial_valid=jnp.asarray(gate[i]))
        assert int(want[3]) == int(got[3][i])
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
        assert not got[2][i, :3].any()


def test_hypothesis_matches_scores_every_hypothesis_as_the_reference(rng):
    """The matches and rigidity score of each of 4 hypotheses, against the
    reference's mutual NN and rigidity_score on that hypothesis: equal;
    consensus_match is choose_hypothesis of them."""
    from rift_tpu.registration.consensus import rigidity_score as j_score
    from rift_tpu_torch.registration import (choose_hypothesis, consensus_match,
                                             hypothesis_matches)

    b, n, c, tau = 2, 64, 8, 0.04
    src, dst, _ = _rigid_set(rng, b, n, n)
    feat_dst = rng.randn(b, n, c).astype(np.float32)
    feat_src_h = (feat_dst[:, None] + rng.uniform(0.1, 2.0, (b, 4, 1, 1))
                  * rng.randn(b, 4, n, c)).astype(np.float32)
    args = tuple(map(torch.from_numpy, (src, dst, feat_src_h, feat_dst)))
    i1s, i2s, masks, scores = hypothesis_matches(*args, tau=tau)
    assert scores.shape == (b, 4) and scores.dtype == torch.int64
    for i in range(b):
        for h in range(4):
            w1, w2, wm = j_mnn(jnp.asarray(feat_src_h[i, h]), jnp.asarray(feat_dst[i]))
            np.testing.assert_array_equal(i2s[i, h].numpy(), np.asarray(w2))
            np.testing.assert_array_equal(masks[i, h].numpy(), np.asarray(wm))
            assert int(scores[i, h]) == int(j_score(jnp.asarray(src[i]), jnp.asarray(dst[i]),
                                                     w1, w2, wm, tau))
    for g, w in zip(consensus_match(*args, tau=tau),
                    choose_hypothesis(i1s, i2s, masks, scores)):
        assert torch.equal(g, w)


def test_consensus_ties_go_to_the_first_hypothesis(rng):
    from rift_tpu_torch.registration import consensus_match

    src, dst, _ = _rigid_set(rng, 1, 32, 32)
    feat = rng.randn(1, 32, 8).astype(np.float32)
    same = np.repeat(feat[:, None], 4, 1)  # 4 equal hypotheses: equal scores
    _, _, mask, h = consensus_match(*map(torch.from_numpy, (src, dst, same, feat)))
    assert int(h[0]) == 0 and bool(mask.all())


@pytest.mark.parametrize("outliers", [0.3, 0.9])
def test_compatibility_core_matches_reference(rng, outliers):
    from rift_tpu.registration.gnc import compatibility_core as j_core
    from rift_tpu_torch.registration import compatibility_core

    b, n, nb = 3, 200, 0.02
    src, dst, _ = _rigid_set(rng, b, n, int(round(n * (1 - outliers))))
    valid = rng.rand(b, n) > 0.05
    # Separated data: every |Δ distance| at least SEPARATED from 2·noise_bound.
    assert _boundary_margin(src, dst, 2 * nb) > SEPARATED
    keep, deg = compatibility_core(*map(torch.from_numpy, (src, dst, valid)), nb)
    for i in range(b):
        wk, wd = j_core(jnp.asarray(src[i]), jnp.asarray(dst[i]), jnp.asarray(valid[i]), nb)
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(wk))
        np.testing.assert_array_equal(deg[i].numpy(), np.asarray(wd))
    inl = int(round(n * (1 - outliers)))
    assert keep[:, :inl][torch.from_numpy(valid[:, :inl])].float().mean() > 0.8


def test_rotation_gnc_tls_and_masked_median_match_reference(rng):
    from rift_tpu.registration.gnc import _masked_component_median as j_median
    from rift_tpu.registration.gnc import _rotation_gnc_tls as j_rot_gnc
    from rift_tpu_torch.registration.gnc import _masked_component_median, _rotation_gnc_tls

    b, n = 3, 120
    src, dst, gt = _rigid_set(rng, b, n, 80)
    v = src - src[:, :1]
    w = dst - dst[:, :1]
    valid = rng.rand(b, n) > 0.1
    valid[:, 0] = False  # the anchor itself
    got = _rotation_gnc_tls(torch.from_numpy(v), torch.from_numpy(w),
                            torch.from_numpy(valid), 0.04).numpy()
    for i in range(b):
        want = np.asarray(j_rot_gnc(jnp.asarray(v[i]), jnp.asarray(w[i]),
                                    jnp.asarray(valid[i]), 0.04))
        # 40 iterations of the same weights from the same start: f32 rounding.
        np.testing.assert_allclose(got[i], want, atol=1e-5)
        np.testing.assert_allclose(got[i], gt[i, :3, :3], atol=2e-2)
    # The median: exact (a sort and a pick), with all, some and no rows valid.
    x = rng.randn(4, 37, 3).astype(np.float32)
    mask = rng.rand(4, 37) > 0.5
    mask[1] = True
    mask[2] = False
    mask[3] = False
    mask[3, 5] = True
    got = _masked_component_median(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    want = np.stack([np.asarray(j_median(jnp.asarray(x[i]), jnp.asarray(mask[i])))
                     for i in range(4)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[3], x[3, 5])


@pytest.mark.parametrize("polish", [True, False])
@pytest.mark.parametrize("outliers", [0.3, 0.9])
def test_teaser_pose_matches_reference(rng, outliers, polish):
    """The TEASER-style pose on well-determined sets (tens of inliers, 30%
    and 90% outliers, as tests/test_registration.py's TEASER tests): the
    same inliers and the pose recovered on both. With the polish, GNC-TLS
    ends at the same weights (all 0 or 1 here): transforms within 1e-5.
    Without it the pose is the TIM rotation's 40 fixed GNC iterations,
    whose band weights amplify rounding as μ grows by 1.4⁴⁰ (differences
    up to 1.04e-4 seen): within 3e-4, under a fifth of that pose's own
    error to the truth (1.6e-3 or more here)."""
    from rift_tpu.registration.gnc import teaser_pose as j_teaser
    from rift_tpu_torch.registration import teaser_pose

    b, n, nb = 3, 256, 0.02
    inl = int(round(n * (1 - outliers)))
    src, dst, gt = _rigid_set(rng, b, n, inl)
    valid = np.ones((b, n), bool)
    assert _boundary_margin(src, dst, 2 * nb) > SEPARATED
    t, w = teaser_pose(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(valid),
                       noise_bound=nb, polish=polish)
    wt, ww = jax.vmap(lambda s, d, v: j_teaser(s, d, v, noise_bound=nb, polish=polish))(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid))
    np.testing.assert_allclose(t.numpy(), np.asarray(wt), atol=1e-5 if polish else 3e-4)
    np.testing.assert_array_equal(w.numpy() > 0.5, np.asarray(ww) > 0.5)
    errs = pair_errors(torch.from_numpy(src), torch.from_numpy(gt), t)
    assert float(errs["rre"].max()) < 2.0 and float(errs["rte"].max()) < 0.05, errs
    assert (w[:, :inl] > 0.5).float().mean() > 0.8


def test_gnc_pose_from_init_transform_matches_reference(rng):
    src, dst, valid = _matches(rng, 3, 128, 0.3)
    init = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    init[:, :3, 3] = rng.uniform(-0.1, 0.1, (3, 3))
    t, w = gnc_pose(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(valid),
                    noise_bound=0.02, init_transform=torch.from_numpy(init))
    wt, ww = jax.vmap(lambda s, d, v, i: j_gnc(s, d, v, noise_bound=0.02, init_transform=i))(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), jnp.asarray(init))
    np.testing.assert_allclose(t.numpy(), np.asarray(wt), atol=1e-4)
    np.testing.assert_allclose(w.numpy(), np.asarray(ww), atol=1e-4)
    # The seed matters: from the identity, a different start than Kabsch.
    t0, _ = gnc_pose(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(valid),
                     noise_bound=0.02, max_iterations=1,
                     init_transform=torch.from_numpy(init))
    t1, _ = gnc_pose(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(valid),
                     noise_bound=0.02, max_iterations=1)
    assert float((t0 - t1).abs().max()) > 1e-3


def test_register_pair_from_matches_matches_reference(rng):
    from rift_tpu.registration.pipeline import register_pair_from_matches as j_from_matches
    from rift_tpu_torch.registration import register_pair, register_pair_from_matches

    b, n = 2, 160
    src, dst, gt = _rigid_set(rng, b, n, 100)
    idx1 = np.stack([rng.permutation(n) for _ in range(b)])
    idx2 = idx1.copy()
    idx2[:, 120:] = rng.randint(0, n, (b, n - 120))
    mask = rng.rand(b, n) > 0.1
    t, inl = register_pair_from_matches(*map(torch.from_numpy, (src, dst, idx1, idx2, mask)))
    for i in range(b):
        wt, winl = j_from_matches(*map(jnp.asarray, (src[i], dst[i], idx1[i], idx2[i], mask[i])),
                                  method="teaserpp")
        np.testing.assert_allclose(t[i].numpy(), np.asarray(wt), atol=1e-4)
        np.testing.assert_array_equal(inl[i].numpy(), np.asarray(winl))
    # The other solvers (held against the reference in
    # tests/test_torch_solvers.py) run here too; an unknown name raises.
    for method in ("ransac", "fgr", "icp", "teaserpp+icp", "ransac+picp", "fgr+pl"):
        t, _ = register_pair_from_matches(*map(torch.from_numpy, (src, dst, idx1, idx2, mask)),
                                          method=method, num_hypotheses=64)
        assert t.shape == (b, 4, 4) and bool(torch.isfinite(t).all())
    with pytest.raises(ValueError, match="unknown method 'svd'"):
        register_pair(*map(torch.from_numpy, (src, dst, src, dst)), method="svd")


def test_meter_registration_matches_reference(rng):
    from rift_tpu.train.meters import MeterRegistration as JMeter
    from rift_tpu_torch.train.meters import MeterRegistration

    ours, ref = MeterRegistration(), JMeter()
    for b in (3, 1, 2):
        errors = {k: rng.rand(b).astype(np.float32)
                  for k in ("rre", "rte", "rmse", "succ", "rmse_succ")}
        t = float(rng.rand())
        ours.update(errors, t)
        ref.update(errors, t)
    assert ours.compute() == ref.compute() and ours.num == ref.num == 6


@pytest.mark.parametrize("mode", ["noise", "clean", "partial", "partial0.5"])
def test_get_pairs_and_batches_give_the_reference_arrays(mode, tmp_path):
    from rift_tpu.data.registration_pairs import get_pairs as j_get_pairs
    from rift_tpu_torch.data import PairBatch, get_pairs

    missing = str(tmp_path / "no_such_file.h5")  # not a file: synthetic pairs
    ours = list(get_pairs(missing, 64, mode, 5).batches(2))
    ref = list(j_get_pairs(missing, 64, mode, 5).batches(2))
    assert [b.source.shape[0] for b in ours] == [2, 2, 1]
    for a, b in zip(ours, ref):
        assert isinstance(a, PairBatch)
        for field in ("source", "target", "transform"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


def test_get_pairs_refuses_what_is_not_ported(tmp_path):
    from rift_tpu_torch.data import get_pairs

    for mode in ("partial0.05", "occluded"):
        with pytest.raises(ValueError, match="pair mode"):
            get_pairs(None, 64, mode, num_pairs=2)
