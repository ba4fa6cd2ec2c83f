"""rift_tpu_torch's classification evaluation against rift_tpu's on the CPU:
`evaluate_classification_ckpt` (test accuracy, the hard tier, 2
rotations, the corruption sweep) on rift_tpu's `train()` checkpoint of
tiny_smoke converted by `weights.from_flax`, on a checkpoint of the port's
own `train()`, and the hard tier and sweep levels themselves."""
import dataclasses
import json
import os
import shutil

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

import rift_tpu.train.loop as j_loop
import rift_tpu_torch.train.loop as t_loop
from rift_tpu.data.modelnet40 import ModelNet40Config as JaxModelNet40Config
from rift_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints
from rift_tpu.train.steps import TrainState as JaxTrainState
from rift_tpu_torch.data.modelnet40 import ModelNet40Config
from rift_tpu_torch.train import (CORRUPTION_LEVELS, build_model, evaluate_classification_ckpt,
                                  get_config, hard_tier_dataset, train)
from rift_tpu_torch.train.config import ModelConfig
from rift_tpu_torch.weights import from_flax
from test_torch_train import _no_dropout, _tiny_configs

KEYS = ["acc", "acc_hard", *[f"sweep_acc_l{i}" for i in range(6)], "sweep_auc", "rot_agree",
        "logit_drift"]
# The same weights and clouds in both packages. Every logit within
# LOGIT_TOL of the largest logit of its batch (measured up to 1.6e-5: the
# inputs are ill-conditioned, tests/test_torch_train.py) and every
# prediction equal, so the accuracies and rot_agree are equal; logit_drift,
# a mean of relative logit spreads, within DRIFT_RTOL (measured 1.7e-6).
LOGIT_TOL, DRIFT_RTOL = 1e-4, 1e-4


@pytest.fixture(scope="module")
def reference_ckpt(tmp_path_factory):
    """rift_tpu's train() of tiny_smoke (one epoch of 2 steps, dropout
    off), its parameters and BN statistics then perturbed (seeded) so that
    the predictions vary, saved by rift_tpu's CheckpointManager and
    written as a port checkpoint beside a copy of its meta file. Returns
    (port dir, reference dir, configs)."""
    cfg, jcfg = _tiny_configs()
    root = tmp_path_factory.mktemp("cls_eval")
    jcfg.train.ckpt_dir = str(root / "trained")
    jcfg.train.steps_per_epoch = 2
    jcfg.optim.num_epochs = 1
    with fnn.intercept_methods(_no_dropout):
        j_loop.train(jcfg, resume=False)
    raw = JaxCheckpoints(jcfg.train.ckpt_dir).restore_raw("common")
    with open(os.path.join(jcfg.train.ckpt_dir, "common.meta.json")) as f:
        snapshot = json.load(f)["config"]
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.uniform(-0.05, 0.05, np.shape(a))).astype(np.float32),
        raw["params"])
    # Running variances cut to a tenth of theirs: two updates leave them near
    # their init of 1, far above the activations' spread, which would hide
    # every input behind the biases.
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (np.asarray(a) * 0.1 if "var" in jax.tree_util.keystr(path)
                         else np.asarray(a) + rng.uniform(-0.05, 0.05, np.shape(a))
                         ).astype(np.float32), raw["batch_stats"])
    ref_dir = str(root / "ref")
    step = int(np.asarray(raw["step"]))
    JaxCheckpoints(ref_dir).save_common(
        JaxTrainState(step=np.int32(step), params=params, batch_stats=stats, opt_state=None),
        {}, jcfg)
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    mcfg = ModelConfig(**{k: v for k, v in snapshot["model"].items() if k in known})
    model = build_model(dataclasses.replace(cfg, model=mcfg))
    model.load_state_dict(from_flax(params, stats))
    port_dir = root / "port"
    port_dir.mkdir()
    torch.save({"model": model.state_dict(), "optimizer": {}, "step": step, "best": {}},
               port_dir / "common.pt")
    shutil.copy(os.path.join(ref_dir, "common.meta.json"), port_dir / "common.meta.json")
    return str(port_dir), ref_dir, cfg, jcfg


def _recording(module, sink):
    """A MeterClassification of `module` that also keeps each batch's
    logits in `sink`."""
    class Recording(module.MeterClassification):
        def update(self, logits, labels):
            sink.append(np.asarray(logits))
            super().update(logits, labels)
    return Recording


def test_evaluate_classification_ckpt_matches_reference(reference_ckpt, monkeypatch):
    port_dir, ref_dir, cfg, jcfg = reference_ckpt
    got_logits, want_logits = [], []
    monkeypatch.setattr(t_loop, "MeterClassification", _recording(t_loop, got_logits))
    monkeypatch.setattr(j_loop, "MeterClassification", _recording(j_loop, want_logits))
    kw = dict(rotations=2, hard_tier=True, corruption_sweep=True)
    got = evaluate_classification_ckpt(cfg, ckpt_dir=port_dir, device="cpu", **kw)
    want = j_loop.evaluate_classification_ckpt(jcfg, ckpt_dir=ref_dir, **kw)
    assert list(got) == list(want) == KEYS
    assert len(got_logits) == len(want_logits) == 8  # test, hard tier, 6 sweep levels
    preds = set()
    for a, b in zip(got_logits, want_logits):
        assert np.abs(a - b).max() <= LOGIT_TOL * np.abs(b).max()
        np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))
        preds |= set(b.argmax(-1).tolist())
    assert len(preds) >= 2  # the perturbed weights predict more than one class
    for key in KEYS[:-1]:
        assert got[key] == want[key], key
    assert got["logit_drift"] == pytest.approx(want["logit_drift"], rel=DRIFT_RTOL)
    assert 0.0 < got["logit_drift"] and all(np.isfinite(list(got.values())))


def test_dataset_overrides_beat_the_snapshot(reference_ckpt, monkeypatch):
    """The snapshot's dataset config applies over the preset's, and the
    `dataset.*` overrides over both (others are ignored); the caller's
    config is left as it was."""
    port_dir, ref_dir, cfg, jcfg = reference_ckpt
    overrides = ["dataset.num_points=48", "dataset.instance_jitter=0.3", "model.dim_k=7"]
    cfg.dataset.num_points = 200  # the snapshot's 64 wins over this
    before = dataclasses.asdict(cfg)
    seen = []
    real = t_loop.ModelNet40

    class Recording(real):
        def __init__(self, config, split):
            seen.append((config.num_points, config.instance_jitter))
            super().__init__(config, split)

    monkeypatch.setattr(t_loop, "ModelNet40", Recording)
    got = evaluate_classification_ckpt(cfg, ckpt_dir=port_dir, rotations=0, hard_tier=False,
                                       cli_overrides=overrides, device="cpu")
    plain = evaluate_classification_ckpt(cfg, ckpt_dir=port_dir, rotations=0, hard_tier=False,
                                         device="cpu")
    assert seen == [(48, 0.3), (64, 0.12)]
    assert dataclasses.asdict(cfg) == before
    want = j_loop.evaluate_classification_ckpt(jcfg, ckpt_dir=ref_dir, rotations=0,
                                               hard_tier=False, cli_overrides=overrides)
    assert got == want and list(got) == ["acc"]
    assert plain["acc"] == j_loop.evaluate_classification_ckpt(
        jcfg, ckpt_dir=ref_dir, rotations=0, hard_tier=False)["acc"]


def test_port_checkpoint_scores_as_its_state(tmp_path):
    """A checkpoint of the port's own train() scores as the state that
    wrote it, given directly; `best_acc` is found by name."""
    cfg = get_config("tiny_smoke")
    cfg.train.ckpt_dir = str(tmp_path)
    cfg.train.steps_per_epoch = 2
    cfg.optim.num_epochs = 1
    out = train(cfg, device="cpu")
    kw = dict(rotations=2, corruption_sweep=True, device="cpu")
    from_ckpt = evaluate_classification_ckpt(cfg, **kw)
    from_state = evaluate_classification_ckpt(cfg, state=out["state"], **kw)
    assert from_ckpt == from_state and list(from_ckpt) == KEYS
    best = evaluate_classification_ckpt(cfg, ckpt_name="best_acc", rotations=0, device="cpu")
    assert best["acc"] == from_ckpt["acc"]
    with pytest.raises(FileNotFoundError):
        evaluate_classification_ckpt(cfg, ckpt_dir=str(tmp_path / "none"), device="cpu")


def test_hard_tier_and_corruption_levels_equal_the_reference():
    assert CORRUPTION_LEVELS == j_loop.CORRUPTION_LEVELS
    for points in (1024, 256):
        ours = dataclasses.asdict(hard_tier_dataset(ModelNet40Config(num_points=points)))
        ref = dataclasses.asdict(j_loop.hard_tier_dataset(JaxModelNet40Config(num_points=points)))
        assert ours == ref
        assert ours["num_points"] == min(points, 512) and ours["occlusion"] == 0.05
