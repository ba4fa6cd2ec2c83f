"""rift_tpu_torch's PVCNN against rift_tpu's on the same weights: a narrow
feature extractor with JAX-initialised parameters, the shipped flagship
checkpoint (mn40_sph_pt_r4) as feature extractor and as classifier, the
dgcnn_kernel block and the sph_dg checkpoint (mn40_sph_dg_r3), the other
spherical checkpoints (UNTESTED below) as feature extractors and as
classifiers, and bench.py's headline model in bf16, each converted by
`weights.from_flax`."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import _make_model
from rift_tpu.models import PVCNNClassifier as JaxPVCNN
from rift_tpu.nn.pvconv import PVConv as JaxPVConv
from rift_tpu.ops.normals import estimate_normals
from rift_tpu_torch.models import PVCNNClassifier, bench_model
from rift_tpu_torch.nn import PVConv
from rift_tpu_torch.weights import from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_DIR = os.path.join(ROOT, "checkpoints", "mn40_sph_pt_r4")
# The committed spherical checkpoints that no other port test reads: the
# earlier sph_dg runs (r2 with 4 global-PPF channels; r2, r2b with no
# lrf_kind in their metas), r5 of the flagship, and the ranking runs (one
# without the local branch).
UNTESTED = ("mn40_sph_dg_r2", "mn40_sph_dg_r2b", "mn40_sph_pt_r5", "rank_ablate_no_local",
            "rank_mn40_sph_dg", "rank_mn40_sph_pt")
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


def _perturb_stats(tree, rng):
    """BN statistics moved off their initial values: means by ±0.05 (kept
    near 0, so deep ReLU stacks stay alive), variances up by 0.1..0.5."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (np.asarray(a) + (rng.uniform(0.1, 0.5, np.shape(a))
                                          if path[-1].key == "var"
                                          else rng.uniform(-0.05, 0.05, np.shape(a)))
                         ).astype(np.float32), tree)


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


def test_small_model_with_lrf_and_canonical_voxels_matches_reference(rng):
    """The evaluation's forward: `use_new_coords_for_voxel=True` and the
    basis given as `lrf` (a random sign flip of each cloud's PCA frame, and
    a random rotation), under the tolerance of the small-model test."""
    from rift_tpu.ops.lrf import lrf_basis as j_lrf_basis
    from rift_tpu.ops.lrf import lrf_flip_hypotheses as j_flips

    cfg = dict(blocks=((16, 1, 8), (32, 1, None)), dim_k=32, is_classify=False,
               point_kernel_formal="pointnet_kernel", voxel_shape="spherical",
               lrf_kind="pca", local_neighbors=16, with_coeff=True, with_se=True,
               use_new_coords_for_voxel=True)
    x = _inputs(rng, 3, 192)
    centred = x[..., :3] - x[..., :3].mean(-2, keepdims=True)
    basis = np.asarray(j_flips(j_lrf_basis(jnp.asarray(centred), "pca")))
    lrf = basis[np.arange(3), [1, 3, 2]]
    q, _ = np.linalg.qr(rng.randn(3, 3))
    lrf[2] = (q * np.sign(np.linalg.det(q))).astype(np.float32)
    jax_model = JaxPVCNN(**cfg)
    variables = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    params = _perturb(variables["params"], rng, -0.05, 0.05)
    stats = {"batch_stats": _perturb(variables["batch_stats"], rng, 0.1, 0.5)}
    want = np.asarray(jax_model.apply({"params": params, **stats}, jnp.asarray(x), train=False,
                                      lrf=jnp.asarray(lrf)))
    model = PVCNNClassifier(**cfg)
    model.load_state_dict(from_flax(params, stats["batch_stats"]))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), lrf=torch.from_numpy(lrf)).numpy()
        default = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 192, 32)
    _compare(got, want)
    # The basis and the voxel frame both count: another basis, or the raw
    # frame for the voxels, gives other features.
    assert np.abs(default - got).max() > 1e-2 * np.abs(want).max()
    model.use_new_coords_for_voxel = False
    with torch.no_grad():
        raw_voxels = model(torch.from_numpy(x), lrf=torch.from_numpy(lrf)).numpy()
    assert np.abs(raw_voxels - got).max() > 1e-2 * np.abs(want).max()


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


@pytest.mark.parametrize("name", ("mn40_sph_pt_r4",) + UNTESTED)
def test_flagship_classifier_logits_match_reference(rng, name):
    directory = os.path.join(ROOT, "checkpoints", name)
    cfg = _load_config(directory)
    raw = _restore(directory)
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


def _load_config(directory):
    with open(os.path.join(directory, "best_acc.meta.json")) as f:
        meta = json.load(f)["config"]["model"]
    # A meta written before the field existed (mn40_sph_dg_r2, r2b) has no
    # lrf_kind: its run had ModelConfig's default, 'reference'.
    cfg = {k: meta.get(k, "reference") if k == "lrf_kind" else meta[k] for k in PORTED}
    cfg["blocks"] = tuple(tuple(b) for b in cfg["blocks"])
    return cfg


def _restore(directory):
    from rift_tpu.train.checkpoint import CheckpointManager

    return CheckpointManager(directory).restore_raw("best_acc")


@pytest.mark.parametrize("with_coeff", [True, False])
def test_dgcnn_pvconv_matches_reference(rng, with_coeff):
    b, n, c, out, r = 2, 160, 7, 16, 8
    feats = rng.randn(b, n, c).astype(np.float32)
    coords = rng.randn(b, n, 3).astype(np.float32)
    jax_block = JaxPVConv(out_channels=out, point_kernel_formal="dgcnn_kernel",
                          voxel_shape="spherical", resolution=r, with_coeff=with_coeff,
                          with_se=True, impl="xla")
    variables = jax_block.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(coords))
    params = {"PVConv_0": _perturb(variables["params"], rng, -0.05, 0.05)}
    stats = {"PVConv_0": _perturb_stats(variables["batch_stats"], rng)}
    want = np.asarray(jax_block.apply({"params": params["PVConv_0"],
                                       "batch_stats": stats["PVConv_0"]},
                                      jnp.asarray(feats), jnp.asarray(coords)))
    block = PVConv(c, out, point_kernel_formal="dgcnn_kernel", resolution=r,
                   with_coeff=with_coeff, with_se=True)
    prefix = "layers.PVConv_0."
    block.load_state_dict({k[len(prefix):]: v for k, v in from_flax(params, stats).items()})
    assert block.point.layers[0]["dense"].in_features == 2 * c
    with torch.no_grad():
        got = block.eval()(torch.from_numpy(feats), torch.from_numpy(coords)).numpy()
    # One block: f32 rounding only, with the farthest (undefined) point's
    # edge of 0 included.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("lrf_kind", ["pca", "reference"])
def test_dgcnn_model_with_global_ppf_matches_reference_in_f32(rng, lrf_kind):
    cfg = dict(blocks=((16, 1, 8), (32, 1, 8), (32, 1, None)), dim_k=32, is_classify=False,
               point_kernel_formal="dgcnn_kernel", voxel_shape="spherical", lrf_kind=lrf_kind,
               extra_feature_channels=4, local_neighbors=32, with_coeff=True, with_se=True)
    x = _inputs(rng, 2, 128)
    jax_model = JaxPVCNN(**cfg)
    variables = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    params = _perturb(variables["params"], rng, -0.05, 0.05)
    stats = _perturb_stats(variables["batch_stats"], rng)
    want = np.asarray(jax_model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                      train=False))
    model = PVCNNClassifier(**cfg)
    assert model.layers["PVConv_0"].convs[0].in_channels == 3 + 4 + 64
    model.load_state_dict(from_flax(params, stats))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 128, 32) and np.abs(want).max() > 0
    _compare(got, want)


@pytest.mark.parametrize("name", ("mn40_sph_dg_r3",) + UNTESTED)
def test_sph_dg_checkpoint_matches_reference(rng, name):
    """The checkpoint's trunk (the dgcnn_kernel sph_dg_r3, and the
    UNTESTED trees): from_flax maps every leaf of it (it raises on any it
    leaves unused) and the features agree."""
    directory = os.path.join(ROOT, "checkpoints", name)
    cfg = _load_config(directory)
    raw = _restore(directory)
    trunk = ("PVConv_", "SharedMLP_")
    params = {k: v for k, v in raw["params"].items() if k.startswith(trunk)}
    stats = {k: v for k, v in raw["batch_stats"].items() if k.startswith(trunk)}
    # xyz' (+ 4 global-PPF channels) (+ the 64 local-PPF channels), doubled
    # by a dgcnn_kernel's edge features.
    c_in = (3 + 4 * (cfg["extra_feature_channels"] == 4)
            + 64 * (cfg["with_local_feat"] is not None))
    edge = 2 if cfg["point_kernel_formal"] == "dgcnn_kernel" else 1
    assert np.shape(params["PVConv_0"]["SharedMLP_0"]["Dense_0"]["kernel"]) == (edge * c_in, 64)
    x = _inputs(rng, 1, 256)
    want = np.asarray(JaxPVCNN(**cfg, is_classify=False).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=False))
    model = PVCNNClassifier(**cfg, is_classify=False)
    model.load_state_dict(from_flax(_to_numpy(params), _to_numpy(stats)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 256, 512)
    _compare(got, want)


def test_bench_model_is_bench_py_model():
    """bench_model() has exactly the parameters of bench.py's
    _make_model("dgcnn"), mapped by from_flax, and computes in bf16."""
    jax_model = _make_model("dgcnn")
    shapes = jax.eval_shape(lambda x: jax_model.init(jax.random.PRNGKey(0), x, train=False),
                            jax.ShapeDtypeStruct((1, 64, 6), jnp.float32))
    variables = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes)
    state = from_flax(variables["params"], variables["batch_stats"])
    model = bench_model("dgcnn")
    model.load_state_dict(state)  # strict: same names and shapes
    assert model.dtype == torch.bfloat16 and jax_model.dtype == "bfloat16"
    assert model.layers["PVConv_0"].convs[0].in_channels == 71
    assert model.layers["PVConv_0"].point.layers[0]["dense"].in_features == 142


def test_bench_model_in_bf16_matches_reference(rng):
    """bench.py's model in bf16 at small widths, n = 128 and k = 32, so
    that n²·k <= 2^24 and the reference's CPU run takes its bf16 eval
    local-PPF path (local_ppf_grouped_fast), the TPU path's function."""
    cfg = dict(blocks=((16, 1, 8), (32, 1, 8), (32, 1, None)), dim_k=32, is_classify=False,
               point_kernel_formal="dgcnn_kernel", voxel_shape="spherical",
               lrf_kind="reference", extra_feature_channels=4, local_neighbors=32,
               with_coeff=True, with_se=True, dtype="bfloat16")
    x = _inputs(rng, 2, 128)
    jax_model = JaxPVCNN(**cfg)
    variables = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    params = _perturb(variables["params"], rng, -0.05, 0.05)
    stats = _perturb_stats(variables["batch_stats"], rng)
    want = np.asarray(jax_model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                      train=False))
    model = PVCNNClassifier(**cfg)
    model.load_state_dict(from_flax(params, stats))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (2, 128, 32)
    # bf16 keeps 8 significant bits and both sides round at every layer,
    # the reference's CPU run more often: it sums the voxel means in bf16
    # (ops/voxelize.py, where the Pallas kernel and the port sum in f32) and
    # its fused local-PPF channels differ by one f32 reassociation. The
    # outputs leave the last layer in bf16, so a one-step difference there
    # is 2^-8 of the value. Every point's largest difference within 4 bf16
    # steps of the largest feature, the median within 2.
    ulp = 2.0 ** -8 * np.abs(want).max()
    err = np.abs(got - want).max(-1)
    assert err.max() <= 4 * ulp, err.max() / ulp
    assert np.median(err) <= 2 * ulp, np.median(err) / ulp


# Every ported model and nn class with a flax twin; the keyword arguments
# that only one side has: the port's input width and head dropout rate
# (flax reads the width from the input; the reference's rate is fixed at
# the port's default), the reference's ShapeNet `extra_feature_channels`
# (its trainer never reads it) and PVConv's `impl` (the XLA or Pallas
# route of the reference's scatter).
TWINS = [("rift_tpu_torch.models.pvcnn", "rift_tpu.models.pvcnn", "PVCNNClassifier",
          {"in_channels", "dropout"}),
         ("rift_tpu_torch.models.shapenet", "rift_tpu.models.shapenet", "ShapeNetPVCNN",
          {"in_channels", "dropout", "extra_feature_channels"}),
         ("rift_tpu_torch.models.pointnet", "rift_tpu.models.pointnet", "PointNet",
          {"in_channels"}),
         ("rift_tpu_torch.models.pointnet", "rift_tpu.models.pointnet", "PointNetClassifier",
          {"in_channels", "dropout"}),
         ("rift_tpu_torch.nn.pointnet2", "rift_tpu.nn.pointnet2", "PointNetAModule", set()),
         ("rift_tpu_torch.nn.pointnet2", "rift_tpu.nn.pointnet2", "PointNetSAModule", set()),
         ("rift_tpu_torch.nn.pointnet2", "rift_tpu.nn.pointnet2", "PointNetFPModule", set()),
         ("rift_tpu_torch.nn.shared_mlp", "rift_tpu.nn.shared_mlp", "SharedMLP", set()),
         ("rift_tpu_torch.nn.pvconv", "rift_tpu.nn.pvconv", "SE3d", set()),
         ("rift_tpu_torch.nn.pvconv", "rift_tpu.nn.pvconv", "PVConv", {"impl"})]


@pytest.mark.parametrize("port_module, ref_module, name, one_sided", TWINS,
                         ids=[t[2] for t in TWINS])
def test_constructor_defaults_equal_the_reference_field_defaults(port_module, ref_module, name,
                                                                 one_sided):
    """The same constructor call builds the same function: every keyword
    default of the port's class equals the reference's field default, and
    the defaulted keywords differ only by `one_sided` (required arguments,
    such as input widths that flax reads from the input, are not compared)."""
    import dataclasses
    import importlib
    import inspect

    port = getattr(importlib.import_module(port_module), name)
    ref = getattr(importlib.import_module(ref_module), name)
    ref_defaults = {f.name: f.default for f in dataclasses.fields(ref)
                    if f.name not in ("parent", "name") and f.default is not dataclasses.MISSING}
    port_defaults = {k: p.default for k, p in inspect.signature(port.__init__).parameters.items()
                     if p.default is not inspect.Parameter.empty}
    assert set(ref_defaults) ^ set(port_defaults) <= one_sided, (
        set(ref_defaults) ^ set(port_defaults))
    for key in sorted(set(ref_defaults) & set(port_defaults)):
        assert port_defaults[key] == ref_defaults[key], (key, port_defaults[key],
                                                         ref_defaults[key])
