"""The two cube checkpoints (`checkpoints/rank_mn40_cu_dg`,
`rank_mn40_cu_pt`) in rift_tpu_torch against rift_tpu: every leaf
converted by `weights.from_flax`, the trunks' features with canonical
voxels, and `evaluate_registration` on the converted `rank_mn40_cu_dg`
with its own `evaluate` section (teaserpp) and with the RANSAC methods
(the port's generator against the reference's keys: held by the pair's
success and, where both recover, RRE/RTE). Kept apart from
tests/test_torch_cube.py so that a worker of its own restores them."""
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.models import PVCNNClassifier as JaxPVCNN
from rift_tpu.ops.lrf import lrf_basis as j_lrf_basis
from rift_tpu.ops.lrf import lrf_flip_hypotheses as j_flips
from rift_tpu.ops.normals import estimate_normals
from rift_tpu.train import get_config as j_get_config
from rift_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints
from rift_tpu_torch.models import PVCNNClassifier
from rift_tpu_torch.train import get_config
from rift_tpu_torch.train import loop as t_loop
from rift_tpu_torch.train.config import ModelConfig
from rift_tpu_torch.weights import from_flax
from test_torch_eval import EVAL_SMALL, RECOVERED, _hold, _run_both

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUBE_DIRS = {kind: os.path.join(ROOT, "checkpoints", f"rank_mn40_cu_{kind}")
             for kind in ("dg", "pt")}
# RANSAC alone ends on its draws' refit and 3 IRLS steps: with the port's
# generator and the reference's keys, the two runs keep other hypotheses,
# and a recovered pair's pose moves with them (0.21 degrees on these
# pairs). It is held by the pair's success and, where both recover, RRE
# within RANSAC_RRE_TOL degrees and RTE within RANSAC_RTE_TOL. The '+picp'
# refiners converge from either draw to the same ICP fixed point and take
# the deterministic tolerances of test_torch_eval.
RANSAC_RRE_TOL, RANSAC_RTE_TOL = 1.0, 1e-2
PORTED = ("blocks", "dim_k", "point_kernel_formal", "voxel_shape", "with_coeff", "with_se",
          "extra_feature_channels", "width_multiplier", "voxel_resolution_multiplier",
          "rot_invariant_preprocess", "lrf_kind", "with_local_feat", "local_neighbors")


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _snapshot(directory):
    with open(os.path.join(directory, "best_acc.meta.json")) as f:
        return json.load(f)["config"]


@pytest.fixture(scope="module", params=sorted(CUBE_DIRS))
def cube(request):
    """(kind, model config, restored arrays) of one cube checkpoint."""
    directory = CUBE_DIRS[request.param]
    meta = _snapshot(directory)["model"]
    cfg = {k: meta[k] for k in PORTED}
    cfg["blocks"] = tuple(tuple(b) for b in cfg["blocks"])
    assert cfg["voxel_shape"] == "cube"
    return request.param, cfg, JaxCheckpoints(directory).restore_raw("best_acc")


def test_cube_checkpoint_converts_whole(cube):
    """from_flax maps every leaf (it raises on any it leaves unused) into
    the classifier's state dict, strictly; the cube blocks' layout is the
    spherical ones'."""
    kind, cfg, raw = cube
    model = PVCNNClassifier(**cfg, is_classify=True)
    state = from_flax(_to_numpy(raw["params"]), _to_numpy(raw["batch_stats"]))
    model.load_state_dict(state)  # strict
    c_in = 3 + 64  # xyz' + the local-PPF channels
    assert model.layers["PVConv_0"].cube
    assert model.layers["PVConv_0"].point.layers[0]["dense"].in_features == (
        2 * c_in if kind == "dg" else c_in)


def test_cube_checkpoint_features_with_canonical_voxels_match_reference(rng, cube):
    """The trunk as the evaluation runs it: `use_new_coords_for_voxel` and
    the basis given as `lrf` (a source's 4 flips and a target's frame)."""
    _, cfg, raw = cube
    trunk = ("PVConv_", "SharedMLP_")
    params = {k: v for k, v in raw["params"].items() if k.startswith(trunk)}
    stats = {k: v for k, v in raw["batch_stats"].items() if k.startswith(trunk)}
    u = rng.uniform(0, 2 * np.pi, (1, 256))
    v = rng.uniform(0.05, np.pi - 0.05, (1, 256))
    pts = np.stack([np.sin(v) * np.cos(u), 0.7 * np.sin(v) * np.sin(u), 0.5 * np.cos(v)], -1)
    pts[:, :64, 0] += 0.6
    pts = (pts + 0.005 * rng.randn(*pts.shape)).astype(np.float32)
    x1 = np.concatenate([pts, np.asarray(estimate_normals(jnp.asarray(pts), impl="xla"))], -1)
    x = np.repeat(x1, 5, 0).astype(np.float32)
    centred = pts - pts.mean(-2, keepdims=True)
    basis = np.asarray(j_lrf_basis(jnp.asarray(centred), cfg["lrf_kind"]))
    lrf = np.concatenate([np.asarray(j_flips(jnp.asarray(basis)))[0], basis], 0)
    want = np.asarray(JaxPVCNN(**cfg, is_classify=False, use_new_coords_for_voxel=True).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=False,
        lrf=jnp.asarray(lrf)))
    model = PVCNNClassifier(**cfg, is_classify=False, use_new_coords_for_voxel=True)
    model.load_state_dict(from_flax(_to_numpy(params), _to_numpy(stats)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), lrf=torch.from_numpy(lrf)).numpy()
    assert got.shape == want.shape == (5, 256, 512)
    # As tests/test_torch_model.py's _compare: a one-ulp change in a voxel
    # boundary or a ball-query radius test moves single points.
    err = np.abs(got - want).max(-1) / np.abs(want).max()
    assert (err > 1e-3).mean() <= 0.01, (err > 1e-3).mean()
    assert np.median(err) < 1e-5, np.median(err)


@pytest.fixture(scope="module")
def cu_dg_ckpt(tmp_path_factory):
    """rank_mn40_cu_dg written as a port checkpoint: `best_acc.pt` (the
    classifier's state dict) beside a copy of its meta file."""
    directory = CUBE_DIRS["dg"]
    raw = JaxCheckpoints(directory).restore_raw("best_acc")
    snapshot = _snapshot(directory)
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    mcfg = ModelConfig(**{k: v for k, v in snapshot["model"].items() if k in known})
    classifier = t_loop.build_model(dataclasses.replace(get_config("mn40_cu_dg"), model=mcfg))
    classifier.load_state_dict(from_flax(_to_numpy(raw["params"]), _to_numpy(raw["batch_stats"])))
    out = tmp_path_factory.mktemp("cu_dg_port")
    torch.save({"model": classifier.state_dict(), "optimizer": {},
                "step": int(np.asarray(raw["step"])), "best": {}}, out / "best_acc.pt")
    shutil.copy(os.path.join(directory, "best_acc.meta.json"), out / "best_acc.meta.json")
    return str(out), snapshot


@pytest.mark.parametrize("method", ["own", "ransac", "ransac+picp"])
def test_evaluate_registration_on_the_cube_checkpoint_matches_reference(cu_dg_ckpt, monkeypatch,
                                                                        method):
    """evaluate_registration on rank_mn40_cu_dg with its own evaluate
    section (teaserpp, flips, canonical voxels) and with the RANSAC
    methods, on EVAL_SMALL: equal `succ` per pair, RRE/RTE within
    test_torch_eval's tolerances where both recover (RANSAC alone within
    RANSAC_RRE_TOL and RANSAC_RTE_TOL). The RANSAC draws differ (a torch
    generator against JAX keys), so these hold the result, not the
    samples."""
    ckpt_dir, snapshot = cu_dg_ckpt
    cfg, jcfg = get_config("mn40_cu_dg"), j_get_config("mn40_cu_dg")
    assert dataclasses.asdict(cfg.evaluate) == snapshot["evaluate"]
    for c in (cfg, jcfg):
        for k, v in EVAL_SMALL.items():
            setattr(c.evaluate, k, v)
        if method != "own":
            c.evaluate.method = method
    t_res, got, j_res, want = _run_both(
        monkeypatch, ((cfg,), dict(ckpt_dir=ckpt_dir, ckpt_name="best_acc")),
        ((jcfg,), dict(ckpt_dir=CUBE_DIRS["dg"], ckpt_name="best_acc")))
    if method == "ransac":
        np.testing.assert_array_equal(got["succ"], want["succ"])
        both = (got["rre"] < RECOVERED) & (want["rre"] < RECOVERED)
        np.testing.assert_allclose(got["rre"][both], want["rre"][both], rtol=0,
                                   atol=RANSAC_RRE_TOL)
        np.testing.assert_allclose(got["rte"][both], want["rte"][both], rtol=0,
                                   atol=RANSAC_RTE_TOL)
    else:
        both = _hold(t_res, got, j_res, want, EVAL_SMALL["num_pairs"])
    assert both.any(), (got["rre"], want["rre"])  # the trained trunk recovers pairs


MAP_PRESET = "reg_icl_nuim_teaserpp_cu_dg"  # map-sequence's default: this cube trunk
MAP_SCENE = 512


def test_map_sequence_on_the_cube_checkpoint_matches_reference(cu_dg_ckpt, monkeypatch):
    """run_map_sequence of MAP_PRESET (teaserpp, flips, canonical voxels)
    on the trained rank_mn40_cu_dg trunk, 8 scans of 256 points, against
    rift_tpu's on its own checkpoint: the same edges, and measurements,
    odometry, graph and BA poses and every ATE within
    tests/test_torch_sequence.py's MAP_TOL. Each package extracts its own
    features, so this holds the map a trained trunk gives, not oracle
    features. The room is sampled from MAP_SCENE points, so that a scan
    of 256 holds half of them and an edge keeps ~60% inliers: from the
    preset's 16384, two 256-point scans share almost no point within the
    noise bound, TEASER ends on 2-7 inliers, and rounding picks its fixed
    point in either package (ROADMAP §3), which no pose rule can hold."""
    import rift_tpu.registration.sequence as j_seq
    import rift_tpu.train.loop as j_loop
    from test_torch_sequence import MAP_TOL

    ckpt_dir, _ = cu_dg_ckpt
    cfg, jcfg = get_config(MAP_PRESET), j_get_config(MAP_PRESET)
    for c in (cfg, jcfg):
        c.sequence.num_scans, c.sequence.num_points, c.sequence.scene_points = 8, 256, MAP_SCENE
    results = {}
    for key, module in (("port", t_loop), ("ref", j_seq)):
        run = module.map_sequence
        monkeypatch.setattr(module, "map_sequence", lambda *a, run=run, key=key, **kw:
                            results.setdefault(key, run(*a, **kw)))
    got_m = t_loop.run_map_sequence(cfg, ckpt_dir=ckpt_dir, ckpt_name="best_acc", device="cpu")
    want_m = j_loop.run_map_sequence(jcfg, ckpt_dir=CUBE_DIRS["dg"], ckpt_name="best_acc")
    got, want = results["port"], results["ref"]
    assert list(got_m) == list(want_m) and got_m["num_edges"] == want_m["num_edges"] == 8
    for a, b in zip(got.edges, want.edges):
        np.testing.assert_array_equal(a, b)
    for k in ("measurements", "odometry", "graph", "ba"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=0, atol=MAP_TOL,
                                   err_msg=k)
    for k in ("ate_odometry", "ate_graph", "ate_ba"):
        assert abs(got_m[k] - want_m[k]) < MAP_TOL, k
    assert got_m["ate_ba"] < 0.05 and got_m["mean_edge_inliers"] > 0.3  # the trunk maps the room
