"""rift_tpu_torch's PVCNN against rift_tpu's on the same weights: a narrow
feature extractor with JAX-initialised parameters, and the shipped flagship
checkpoint (mn40_sph_pt_r4) as feature extractor and as classifier, each
converted by `weights.from_flax`."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.models import PVCNNClassifier as JaxPVCNN
from rift_tpu.ops.normals import estimate_normals
from rift_tpu_torch.models import PVCNNClassifier
from rift_tpu_torch.weights import from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_DIR = os.path.join(ROOT, "checkpoints", "mn40_sph_pt_r4")
PORTED = ("blocks", "dim_k", "point_kernel_formal", "voxel_shape", "with_coeff", "with_se",
          "extra_feature_channels", "width_multiplier", "voxel_resolution_multiplier",
          "rot_invariant_preprocess", "lrf_kind", "with_local_feat", "local_neighbors")


def _inputs(rng, b, n):
    """Clouds on a noisy ellipsoid with the reference's normals: [b, n, 6]."""
    u = rng.uniform(0, 2 * np.pi, (b, n))
    v = rng.uniform(0.05, np.pi - 0.05, (b, n))
    pts = np.stack([np.sin(v) * np.cos(u), 0.7 * np.sin(v) * np.sin(u), 0.5 * np.cos(v)], -1)
    pts[:, : n // 4, 0] += 0.6  # asymmetric, so the PCA frame is well defined
    pts = (pts + 0.005 * rng.randn(*pts.shape)).astype(np.float32)
    nrm = np.asarray(estimate_normals(jnp.asarray(pts), impl="xla"))
    return np.concatenate([pts, nrm], -1).astype(np.float32)


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb(tree, rng, lo, hi):
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.uniform(lo, hi, np.shape(a))).astype(np.float32), tree)


def _compare(got, want):
    """A one-ulp difference in a voxel boundary or a ball-query radius test
    moves single points; everywhere else the two forwards agree to f32
    rounding through ~10 layers. Bound the share of points that differ by
    more than 1e-3 of the largest feature, and the rest tightly."""
    scale = np.abs(want).max()
    err = np.abs(got - want).max(-1) / scale
    assert (err > 1e-3).mean() <= 0.01, (err > 1e-3).mean()
    assert np.median(err) < 1e-5, np.median(err)


def test_small_model_matches_reference(rng):
    cfg = dict(blocks=((16, 1, 8), (32, 1, None)), dim_k=32, is_classify=False,
               point_kernel_formal="pointnet_kernel", voxel_shape="spherical",
               lrf_kind="pca", local_neighbors=16, with_coeff=True, with_se=True)
    x = _inputs(rng, 2, 192)
    jax_model = JaxPVCNN(**cfg)
    variables = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    params = _perturb(variables["params"], rng, -0.05, 0.05)
    stats = {"batch_stats": _perturb(variables["batch_stats"], rng, 0.1, 0.5)}
    want = np.asarray(jax_model.apply({"params": params, **stats}, jnp.asarray(x), train=False))
    model = PVCNNClassifier(**cfg)
    model.load_state_dict(from_flax(params, stats["batch_stats"]))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 192, 32)
    _compare(got, want)


def test_from_flax_rejects_unmapped_keys(rng):
    cfg = dict(blocks=((8, 1, 4),), dim_k=8, is_classify=False,
               point_kernel_formal="pointnet_kernel", local_neighbors=8)
    variables = JaxPVCNN(**cfg).init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 6)), train=False)
    params = _to_numpy(variables["params"])
    stats = _to_numpy(variables["batch_stats"])
    assert set(from_flax(params, stats)) == set(PVCNNClassifier(**cfg).state_dict())
    # A top-level module the port does not know, and a leftover conv inside
    # a block: neither may be dropped silently.
    unknown = dict(params, LayerNorm_0={"scale": np.ones(8, np.float32)})
    with pytest.raises(ValueError, match="LayerNorm_0"):
        from_flax(unknown, stats)
    extra_conv = dict(params, PVConv_0=dict(params["PVConv_0"], Conv_2=params["PVConv_0"]["Conv_0"]))
    with pytest.raises(ValueError, match="Conv_2"):
        from_flax(extra_conv, stats)


@pytest.fixture(scope="module")
def flagship():
    """The flagship checkpoint's model config and its restored arrays."""
    from rift_tpu.train.checkpoint import CheckpointManager

    with open(os.path.join(FLAGSHIP_DIR, "best_acc.meta.json")) as f:
        meta = json.load(f)["config"]["model"]
    cfg = {k: meta[k] for k in PORTED}
    cfg["blocks"] = tuple(tuple(b) for b in cfg["blocks"])
    return cfg, CheckpointManager(FLAGSHIP_DIR).restore_raw("best_acc")


def test_flagship_checkpoint_matches_reference(rng, flagship):
    cfg, raw = flagship
    # The checkpoint was trained as a classifier; registration uses the
    # trunk only, so the head's keys are dropped before conversion.
    trunk = ("PVConv_", "SharedMLP_")
    params = {k: v for k, v in raw["params"].items() if k.startswith(trunk)}
    stats = {k: v for k, v in raw["batch_stats"].items() if k.startswith(trunk)}
    x = _inputs(rng, 1, 256)
    want = np.asarray(JaxPVCNN(**cfg, is_classify=False).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=False))
    model = PVCNNClassifier(**cfg, is_classify=False)
    model.load_state_dict(from_flax(params, stats))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 256, 512)
    _compare(got, want)


def test_flagship_classifier_logits_match_reference(rng, flagship):
    cfg, raw = flagship
    x = _inputs(rng, 2, 256)
    want = np.asarray(JaxPVCNN(**cfg, is_classify=True).apply(
        {"params": raw["params"], "batch_stats": raw["batch_stats"]}, jnp.asarray(x),
        train=False))
    model = PVCNNClassifier(**cfg, is_classify=True)
    model.load_state_dict(from_flax(_to_numpy(raw["params"]), _to_numpy(raw["batch_stats"])))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 40)
    # The max-pool over points takes the trunk's features, equal up to f32
    # rounding but for the rare boundary point (see _compare), then three
    # Dense layers: logits within 1e-4 of the largest.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
