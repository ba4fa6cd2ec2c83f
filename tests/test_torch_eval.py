"""rift_tpu_torch's registration evaluation against rift_tpu's: the
`evaluate` section of the flagship preset, `evaluate_registration` end to
end on the committed flagship checkpoint, read by the port's own orbax
reader (flip hypotheses and canonical voxels on), and on tiny_smoke widths
without the flips, and the checkpoint resolution of `resolve_extractor`."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rift_tpu.train.loop as j_loop
import rift_tpu_torch.train.loop as t_loop
from rift_tpu.train import get_config as j_get_config
from rift_tpu.train.config import EvalConfig as JaxEvalConfig
from rift_tpu.train.config import ModelConfig as JaxModelConfig
from rift_tpu.train.steps import TrainState as JaxTrainState
from rift_tpu_torch.registration import register_pair
from rift_tpu_torch.train import (EvalConfig, evaluate_registration, extractor_from_snapshot,
                                  get_config, resolve_extractor, train)
from rift_tpu_torch.train.checkpoint import CheckpointManager
from rift_tpu_torch.weights import from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_DIR = os.path.join(ROOT, "checkpoints", "mn40_sph_pt_r4")
# Per pair, where both runs recover the pose (RRE under RECOVERED degrees):
# RRE within RRE_TOL degrees and RTE within RTE_TOL. On the flagship's 3
# pairs the port and the reference pick the same hypotheses, masks and
# kept sets; one pair ends GNC-TLS's polish on 5 inliers, where rounding
# moves the fixed point by 7.5e-4 (0.015 degrees, RTE 1.4e-4; ROADMAP §3).
RECOVERED, RRE_TOL, RTE_TOL = 15.0, 0.1, 1e-3
EVAL_SMALL = dict(num_points=256, num_pairs=3, batch_pairs=2)  # a padded tail


def _recording(module, sink):
    """A MeterRegistration of `module` that also keeps each batch's
    per-pair errors in `sink`."""
    class Recording(module.MeterRegistration):
        def update(self, errors, reg_time=0.0):
            sink.append({k: np.asarray(v) for k, v in errors.items()})
            super().update(errors, reg_time)
    return Recording


def _per_pair(batches):
    return {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}


def _run_both(monkeypatch, t_args, j_args):
    """evaluate_registration of the port (device='cpu') and of the
    reference: (results, per-pair errors) of each."""
    got, want = [], []
    monkeypatch.setattr(t_loop, "MeterRegistration", _recording(t_loop, got))
    monkeypatch.setattr(j_loop, "MeterRegistration", _recording(j_loop, want))
    t_res = evaluate_registration(*t_args[0], **t_args[1], device="cpu")
    j_res = j_loop.evaluate_registration(*j_args[0], **j_args[1])
    return t_res, _per_pair(got), j_res, _per_pair(want)


def _hold(t_res, got, j_res, want, num_pairs):
    assert set(t_res) == set(j_res) == {"rre", "rte", "rmse", "succ", "rmse_succ", "reg_time"}
    assert all(np.isfinite(v) for v in t_res.values())
    assert got["rre"].shape == want["rre"].shape == (num_pairs,)
    np.testing.assert_array_equal(got["succ"], want["succ"])
    both = (got["rre"] < RECOVERED) & (want["rre"] < RECOVERED)
    np.testing.assert_allclose(got["rre"][both], want["rre"][both], rtol=0, atol=RRE_TOL)
    np.testing.assert_allclose(got["rte"][both], want["rte"][both], rtol=0, atol=RTE_TOL)
    assert t_res["succ"] == j_res["succ"]
    return both


def test_flagship_preset_evaluate_section_equals_the_meta_file():
    with open(os.path.join(FLAGSHIP_DIR, "best_acc.meta.json")) as f:
        meta = json.load(f)["config"]["evaluate"]
    ours = dataclasses.asdict(get_config("mn40_sph_pt_r4").evaluate)
    assert ours == meta
    assert ours["method"] == "teaserpp" and ours["pairs_mode"] == "noise"
    assert (ours["num_pairs"], ours["num_points"], ours["batch_pairs"]) == (100, 1024, 64)
    assert ours["canonical_voxel"] and ours["flip_hypotheses"]
    # Every field of the reference's EvalConfig, with its default.
    assert dataclasses.asdict(EvalConfig()) == dataclasses.asdict(JaxEvalConfig())


@pytest.fixture(scope="module")
def flagship_ckpt():
    """The committed flagship run (the orbax directory `best_acc/` beside
    its meta file), which the port reads itself: (its directory, the
    config snapshot)."""
    with open(os.path.join(FLAGSHIP_DIR, "best_acc.meta.json")) as f:
        snapshot = json.load(f)["config"]
    return FLAGSHIP_DIR, snapshot


def test_extractor_from_the_converted_flagship(flagship_ckpt):
    ckpt_dir, snapshot = flagship_ckpt
    cfg = get_config("mn40_sph_pt_r4")
    cfg.model.dim_k = 999  # the snapshot's architecture wins
    model = resolve_extractor(cfg, ckpt_dir=ckpt_dir, ckpt_name="best_acc", device="cpu")
    assert model.head is None and model.use_new_coords_for_voxel
    assert model.out_channels == 512 and model.lrf_kind == "pca"
    assert not model.training
    cfg.evaluate.canonical_voxel = False
    assert not extractor_from_snapshot(cfg, snapshot).use_new_coords_for_voxel


def test_evaluate_registration_matches_reference_on_the_flagship(flagship_ckpt, monkeypatch):
    """The flagship's evaluation (teaserpp, flip hypotheses, canonical
    voxels) on 3 noise pairs of 256 points, 2 a batch: per pair equal
    `succ`, and RRE/RTE within RRE_TOL/RTE_TOL where both recover."""
    ckpt_dir, _ = flagship_ckpt
    cfg = get_config("mn40_sph_pt_r4")
    jcfg = j_get_config("mn40_sph_pt")
    for c in (cfg, jcfg):
        for k, v in EVAL_SMALL.items():
            setattr(c.evaluate, k, v)
    t_res, got, j_res, want = _run_both(
        monkeypatch, ((cfg,), dict(ckpt_dir=ckpt_dir, ckpt_name="best_acc")),
        ((jcfg,), dict(ckpt_dir=FLAGSHIP_DIR, ckpt_name="best_acc")))
    both = _hold(t_res, got, j_res, want, 3)
    assert both.all(), (got["rre"], want["rre"])  # the trained flagship recovers all 3
    for k in ("rre", "rte"):
        assert abs(t_res[k] - j_res[k]) <= (RRE_TOL if k == "rre" else RTE_TOL)


def test_chip_smoke_staged_batch_is_register_eval_batch(flagship_ckpt):
    """chip_smoke.py's staged evaluation batch calls the shipped functions
    in register_eval_batch's order: on the CPU its pose is bit-equal to
    register_eval_batch's, its stages are the ones it reports, and its
    hypothesis is the argmax of the scores it reads."""
    import importlib.util

    from rift_tpu_torch.data import get_pairs

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    ckpt_dir, _ = flagship_ckpt
    cfg = get_config("mn40_sph_pt_r4")
    ev = cfg.evaluate
    model = resolve_extractor(cfg, ckpt_dir=ckpt_dir, ckpt_name="best_acc", device="cpu")
    batch = next(get_pairs(ev.pairs_path, 256, ev.pairs_mode, 2).batches(2))
    src, dst = torch.as_tensor(batch.source), torch.as_tensor(batch.target)
    split = {}
    stages = chip_smoke.eval_stages(model, src, dst, ev.noise_bound, timed=split)
    est = t_loop.register_eval_batch(model, src, dst, ev)
    assert torch.equal(stages["transform"], est)
    assert list(split) == ["normals", "forward 5b", "consensus", "TEASER core",
                           "TEASER rotation", "TEASER polish"]
    assert stages["feats"].shape == (5 * 2, 256, model.out_channels)
    assert torch.equal(stages["h"], torch.argmax(stages["scores"], -1))


def test_chip_smoke_reg_stages_are_register_eval_batch():
    """chip_smoke.py's staged reg_noise batch calls the shipped functions in
    register_eval_batch's order for 'ransac+picp': on the CPU, from the same
    generator state, its pose is bit-equal to register_eval_batch's, and its
    stages are the ones it reports."""
    import importlib.util

    from rift_tpu_torch.data import get_pairs

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cfg = get_config("reg_noise")
    assert cfg.evaluate.method == "ransac+picp" and cfg.model.voxel_shape == "cube"
    cfg.model.blocks = ((16, 1, 8), (32, 1, 8), (32, 1, None))
    cfg.model.local_neighbors = 16
    cfg.model.use_new_coords_for_voxel = True
    cfg.evaluate.num_hypotheses = 64
    model = chip_smoke.seeded_model(0, t_loop.build_model(cfg))
    batch = next(get_pairs(None, 128, "noise", 2).batches(2))
    src, dst = torch.as_tensor(batch.source), torch.as_tensor(batch.target)
    split = {}
    stages = chip_smoke.reg_stages(model, src, dst, cfg.evaluate,
                                   torch.Generator().manual_seed(7), timed=split)
    est = t_loop.register_eval_batch(model, src, dst, cfg.evaluate,
                                     torch.Generator().manual_seed(7))
    assert torch.equal(stages["transform"], est)
    assert list(split) == ["normals", "forward 5b", "consensus", "RANSAC sampling",
                           "RANSAC scoring, refit, IRLS", "ICP point-to-point",
                           "normals of the targets", "ICP point-to-plane"]
    assert stages["samples"].shape == (2, 64, 3) and stages["rscore"].shape == (2, 64)


def test_evaluate_registration_matches_reference_at_tiny_smoke_without_flips(rng, monkeypatch):
    """tiny_smoke widths (pointnet, PCA frame), `flip_hypotheses=False`:
    one 2b forward and `register_pair` per batch, the same seeded weights
    on both sides given as an explicit model."""
    cfg = get_config("tiny_smoke")
    cfg.model.is_classify = False
    cfg.evaluate.flip_hypotheses = False
    for k, v in EVAL_SMALL.items():
        setattr(cfg.evaluate, k, v)
    jcfg = j_get_config("tiny_smoke")
    jcfg.model = JaxModelConfig(**dataclasses.asdict(cfg.model))
    jcfg.evaluate = JaxEvalConfig(**dataclasses.asdict(cfg.evaluate))
    jax_model = j_loop.build_model(jcfg)
    variables = jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 256, 6)), train=False)
    perturb = lambda tree, lo, hi: jax.tree_util.tree_map(  # noqa: E731
        lambda a: (np.asarray(a) + rng.uniform(lo, hi, np.shape(a))).astype(np.float32), tree)
    params = perturb(variables["params"], -0.05, 0.05)
    stats = perturb(variables["batch_stats"], 0.1, 0.5)
    model = t_loop.build_model(cfg)
    model.load_state_dict(from_flax(params, stats))
    state = JaxTrainState(step=0, params=params, batch_stats=stats, opt_state=None)
    t_res, got, j_res, want = _run_both(monkeypatch, ((cfg,), dict(model=model)),
                                        ((jcfg,), dict(state=state, model=jax_model)))
    # Random weights: one of the 3 pairs is recovered (4.45 degrees); the
    # others are undetermined and held only by `succ`.
    assert _hold(t_res, got, j_res, want, 3).any(), (got["rre"], want["rre"])


def test_resolve_extractor_picks_the_common_checkpoint_of_train(tmp_path):
    """train() of the port writes `common` into train.ckpt_dir; with no
    ckpt_dir given, evaluation restores it (trunk only, canonical voxels);
    an explicit ckpt_dir wins over it, an explicit model over both; with
    no checkpoint at all a seeded init of config.model is evaluated."""
    cfg = get_config("tiny_smoke")
    cfg.train.ckpt_dir = str(tmp_path / "trained")
    cfg.optim.num_epochs = 1
    cfg.train.steps_per_epoch = 2
    out = train(cfg, device="cpu")
    cfg.evaluate.num_points, cfg.evaluate.num_pairs = 128, 2
    model = resolve_extractor(cfg, device="cpu")
    assert model.head is None and model.use_new_coords_for_voxel
    trained = out["state"].model.state_dict()
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, trained[k], rtol=0, atol=0)
    results = evaluate_registration(cfg, device="cpu")
    assert all(np.isfinite(v) for v in results.values())

    # An explicit ckpt_dir wins: another run's best checkpoint.
    other = get_config("tiny_smoke")
    other.seed = 5
    other.train.ckpt_dir = str(tmp_path / "other")
    other.optim.num_epochs, other.train.steps_per_epoch = 1, 1
    other_state = train(other, device="cpu")["state"].model.state_dict()
    picked = resolve_extractor(cfg, ckpt_dir=other.train.ckpt_dir, ckpt_name="best_acc",
                               device="cpu").state_dict()
    key = "layers.PVConv_0.convs.0.weight"
    torch.testing.assert_close(picked[key], other_state[key], rtol=0, atol=0)
    assert not torch.equal(picked[key], trained[key])
    assert resolve_extractor(cfg, model=model, device="cpu") is model
    with pytest.raises(FileNotFoundError):
        resolve_extractor(cfg, ckpt_dir=str(tmp_path / "empty"), device="cpu")

    # No checkpoint: a seeded init of config.model, which must not be a
    # classifier to register.
    cfg.train.ckpt_dir = str(tmp_path / "none")
    with pytest.raises(ValueError, match="feature extractor"):
        evaluate_registration(cfg, device="cpu")
    cfg.model.is_classify = False
    untrained = resolve_extractor(cfg, device="cpu")
    assert untrained.head is None and not untrained.use_new_coords_for_voxel
    assert all(np.isfinite(v) for v in evaluate_registration(cfg, device="cpu").values())
    cfg.evaluate.method = "ransac+picp"
    assert all(np.isfinite(v) for v in evaluate_registration(cfg, device="cpu").values())
    cfg.evaluate.method = "svd"
    with pytest.raises(ValueError, match="unknown method"):
        evaluate_registration(cfg, device="cpu")


def _tiny_extractor(flips: bool):
    cfg = get_config("tiny_smoke")
    cfg.model.is_classify = False
    cfg.evaluate.flip_hypotheses = flips
    cfg.evaluate.method = "ransac"
    cfg.evaluate.num_hypotheses = 64
    for k, v in EVAL_SMALL.items():
        setattr(cfg.evaluate, k, v)
    model = t_loop.build_model(cfg)
    t_loop.init_params(model, 0)
    return cfg, model.eval()


def test_flip_gate_needs_the_change_coords_preprocess(monkeypatch):
    """register_eval_batch runs the flip hypotheses only when the evaluate
    section asks for them and the trunk's preprocess is 'change_coords'
    (the reference's gate, rift_tpu/train/loop.py:521-522); otherwise one
    2b forward and register_pair. Each preprocess's own trunk, now that
    all are ported."""
    cfg, model = _tiny_extractor(flips=True)
    batch = next(t_loop.get_pairs(None, 128, "noise", 2).batches(2))
    src, dst = torch.as_tensor(batch.source), torch.as_tensor(batch.target)
    seen, flip_features = [], t_loop.flip_features
    monkeypatch.setattr(t_loop, "flip_features",
                        lambda m, x, b: seen.append("5b") or flip_features(m, x, b))
    monkeypatch.setattr(t_loop, "register_pair",
                        lambda *a, **kw: seen.append("2b") or register_pair(*a, **kw))
    for preprocess, path in (("change_coords", "5b"), ("ppf", "2b"), ("new_ppf", "2b"),
                             ("pca", "2b"), (None, "2b")):
        seen.clear()
        cfg.model.rot_invariant_preprocess = preprocess
        model = t_loop.build_model(cfg)
        t_loop.init_params(model, 0)
        model.eval()
        assert t_loop.uses_flips(model, cfg.evaluate) == (path == "5b")
        est = t_loop.register_eval_batch(model, src, dst, cfg.evaluate)
        assert seen == [path] and est.shape == (2, 4, 4)
    cfg.evaluate.flip_hypotheses = False
    model.rot_invariant_preprocess = "change_coords"
    assert not t_loop.uses_flips(model, cfg.evaluate)


def test_evaluation_result_does_not_depend_on_the_warm_up(monkeypatch):
    """evaluate_registration gives the warm-up's RANSAC draws back: the
    timed batches draw what a run without the warm-up would, so the
    result equals the same batches registered from a fresh generator
    seeded with config.seed."""
    cfg, model = _tiny_extractor(flips=False)
    cfg.seed = 3
    got = []
    monkeypatch.setattr(t_loop, "MeterRegistration", _recording(t_loop, got))
    evaluate_registration(cfg, model=model, device="cpu")
    gen = torch.Generator().manual_seed(cfg.seed)
    want = []
    for batch in t_loop.get_pairs(None, EVAL_SMALL["num_points"], cfg.evaluate.pairs_mode,
                                  EVAL_SMALL["num_pairs"]).batches(EVAL_SMALL["batch_pairs"]):
        src, dst = torch.as_tensor(batch.source), torch.as_tensor(batch.target)
        n_real = src.shape[0]
        if n_real < EVAL_SMALL["batch_pairs"]:
            pad = EVAL_SMALL["batch_pairs"] - n_real
            src = torch.cat([src, src[:1].expand(pad, -1, -1)], 0)
            dst = torch.cat([dst, dst[:1].expand(pad, -1, -1)], 0)
        est = t_loop.register_eval_batch(model, src, dst, cfg.evaluate, gen)
        want.append({k: v.numpy() for k, v in t_loop.pair_errors(
            src[:n_real], torch.as_tensor(batch.transform), est[:n_real]).items()})
    got, want = _per_pair(got), _per_pair(want)
    for k in ("rre", "rte", "rmse", "succ"):
        np.testing.assert_array_equal(got[k], want[k])
    # Another seed draws other samples: the seed reaches RANSAC.
    cfg.seed = 4
    other = []
    monkeypatch.setattr(t_loop, "MeterRegistration", _recording(t_loop, other))
    evaluate_registration(cfg, model=model, device="cpu")
    assert not np.array_equal(_per_pair(other)["rre"], got["rre"])


def test_checkpoint_restore_raw_round_trip(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    assert ckpt.restore_raw("common") is None
    torch.save({"model": {"w": torch.ones(2)}, "step": 3}, tmp_path / "common.pt")
    raw = ckpt.restore_raw("common")
    assert raw["step"] == 3 and torch.equal(raw["model"]["w"], torch.ones(2))
