"""rift_tpu_torch's registration stage against rift_tpu's: weighted Kabsch,
GNC-TLS, pair errors, the copied synthetic pairs, and register_batch end to
end on two small pairs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.data.registration_pairs import SyntheticPairs as JaxPairs
from rift_tpu.models import PVCNNClassifier as JaxPVCNN
from rift_tpu.ops.neighbors import mutual_nearest_neighbors as j_mnn
from rift_tpu.ops.normals import estimate_normals as j_normals
from rift_tpu.registration import gnc_pose as j_gnc
from rift_tpu.registration.kabsch import rotation_from_h as j_rot_from_h
from rift_tpu.registration.kabsch import weighted_kabsch as j_kabsch
from rift_tpu.registration.metrics import pair_errors as j_pair_errors
from rift_tpu_torch.data import SyntheticPairs
from rift_tpu_torch.models import PVCNNClassifier
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
