"""Training resumed from the reference's orbax `common` checkpoints, on the
CPU: `CheckpointManager.restore` on every committed `common` (the
parameters and BN statistics as `load_trained_state` converts them, optax's
Adam moments and count on torch's `Adam`, one update against optax's
`tx.update`), a chain with `grad_clip`, the tiny run resumed by the port's
`train` against rift_tpu's resumed `train`, a narrow segmentation run
resumed against the reference's, the port's own resume from `common.pt`
bit for bit, the failures, and the command line. The data-parallel resume
is tests/test_torch_dp.py's. Every run copies the committed directories
into `tmp_path` and writes nothing under `checkpoints/`."""
import dataclasses
import glob
import hashlib
import json
import logging
import os
import shutil

import flax.linen as fnn
import jax
import numpy as np
import optax
import pytest
import torch

import rift_tpu.train.loop as j_loop
import rift_tpu_torch.train.loop as t_loop
from rift_tpu.data.shapenet import ShapeNetConfig as JaxShapeNetConfig
from rift_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints
from rift_tpu.train.config import ExperimentConfig as JaxExperimentConfig
from rift_tpu.train.config import get_config as jax_config
from rift_tpu.train.steps import make_optimizer as jax_make_optimizer
from rift_tpu_torch import cli
from rift_tpu_torch.data.shapenet import ShapeNetConfig
from rift_tpu_torch.train import (ExperimentConfig, apply_overrides, build_model,
                                  build_seg_model, get_config, train, train_segmentation)
from rift_tpu_torch.train.checkpoint import CheckpointManager, checkpoint_exists
from rift_tpu_torch.train.loop import load_trained_state
from rift_tpu_torch.train.orbax_read import read_orbax
from rift_tpu_torch.train.steps import apply_update, create_state
from rift_tpu_torch.train.utils import get_logger
from rift_tpu_torch.weights import adam_from_flax, from_flax, from_flax_shapenet
from test_torch_train import LOSS_RTOL, PARAM_TOL, _no_dropout, _np, _tiny_configs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints")
COMMON_RUNS = sorted(os.path.relpath(os.path.dirname(os.path.dirname(p)), CKPT)
                     for p in glob.glob(os.path.join(CKPT, "**", "common", "_METADATA"),
                                        recursive=True))
CPU = torch.device("cpu")
# The reference's tiny_smoke model, which wrote checkpoints/common: the
# port's preset takes the flagship's kernel and LRF, so these make it equal.
TINY_AS_SNAPSHOT = ["model.point_kernel_formal=dgcnn_kernel", "model.lrf_kind=reference"]
SEG_ITEMS = {"train": 8, "test": 4}
# Parameters after a resumed epoch against the reference's. The two runs
# start from the same state and take the same batches, so they part by
# rounding alone; but Adam moves an element by up to about lr times the
# sign of its update, so where an update is rounding (a gradient that is
# zero to rounding), each step may put the two runs up to 2·lr apart. So
# every element is held within 2·Σ lr_t over the epoch's updates
# (SIGN_SLACK covers Adam's m/√v a little above 1; measured up to 0.71 of
# Σ lr_t at tiny_smoke and 1.14 for the narrow segmentation model), and
# the run as a whole by its median element, within RUN_PARAM_MEDIAN of
# Σ lr_t (measured 4.9e-5 and 9.2e-5). The running statistics follow the
# parameters through the epoch's forwards: within EPOCH_STATS_TOL of the
# largest (measured 4.2e-5 and 5.5e-6; one step's rule, STATS_TOL, is
# 1e-5).
SIGN_SLACK, RUN_PARAM_MEDIAN, EPOCH_STATS_TOL = 1.05, 1e-3, 2e-4


def _tiny_as_snapshot() -> ExperimentConfig:
    """The port's tiny_smoke preset with TINY_AS_SNAPSHOT."""
    return apply_overrides(get_config("tiny_smoke"), TINY_AS_SNAPSHOT)


def _snapshot(run_dir: str, name: str = "common") -> dict:
    with open(os.path.join(run_dir, f"{name}.meta.json")) as f:
        return json.load(f)


def _set_fields(target, values: dict) -> None:
    known = {f.name for f in dataclasses.fields(target)}
    for key, value in values.items():
        if key in known:
            setattr(target, key, tuple(tuple(b) for b in value) if key == "blocks" else value)


def _configs(snapshot: dict, num_epochs: int):
    """The port's and the reference's configs of a snapshot's model and
    optimizer, with `num_epochs` in place of the run's."""
    cfg, jcfg = ExperimentConfig(name=snapshot["name"]), JaxExperimentConfig(name=snapshot["name"])
    for c in (cfg, jcfg):
        _set_fields(c.model, snapshot["model"])
        _set_fields(c.optim, snapshot["optim"])
        c.optim.num_epochs = num_epochs
    return cfg, jcfg


def _is_seg(snapshot: dict) -> bool:
    return snapshot["name"] == "shapenet_seg"


def _tree_sha256(directory: str) -> dict:
    """Every file under `directory`, by its relative path: its sha256."""
    out = {}
    for path in sorted(glob.glob(os.path.join(directory, "**"), recursive=True)):
        if os.path.isfile(path):
            with open(path, "rb") as f:
                out[os.path.relpath(path, directory)] = hashlib.sha256(f.read()).hexdigest()
    return out


def _copy_common(src_dir: str, dst_dir: str) -> str:
    """`common/` and `common.meta.json` of `src_dir` into `dst_dir`."""
    os.makedirs(dst_dir, exist_ok=True)
    shutil.copytree(os.path.join(src_dir, "common"), os.path.join(dst_dir, "common"))
    shutil.copy(os.path.join(src_dir, "common.meta.json"), dst_dir)
    return dst_dir


def _said(name: str):
    """The messages that the port's logger `name` records from now on."""
    said = []
    handler = logging.Handler()
    handler.emit = lambda record: said.append(record.getMessage())
    get_logger(name).addHandler(handler)
    return said, handler


def _seeded_grads(params: dict, seed: int, scale: float = 1.0) -> dict:
    """Normal gradients of the flax tree `params`' shapes, f32 numpy."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(scale * rng.standard_normal(np.shape(a)), np.float32), params)


def _held_after_epoch(got: dict, want: dict, rates: list) -> None:
    """The port's state dict after a resumed epoch against the reference's
    (both converted to the port's names): parameters by the rule at
    SIGN_SLACK and RUN_PARAM_MEDIAN, running statistics within
    EPOCH_STATS_TOL of the largest."""
    reach = 2.0 * SIGN_SLACK * sum(rates)
    medians = []
    for name, value in got.items():
        off = (value - want[name]).abs()
        if "running" in name:
            continue
        assert float(off.max()) <= reach, (name, float(off.max()) / sum(rates))
        medians.append(off.flatten())
    median = float(torch.cat(medians).median()) / sum(rates)
    assert median <= RUN_PARAM_MEDIAN, median
    scale = max(float(want[k].abs().max()) for k in got if "running" in k)
    for name in got:
        if "running" in name:
            assert float((got[name] - want[name]).abs().max()) <= EPOCH_STATS_TOL * scale, name


@pytest.mark.parametrize("run", COMMON_RUNS)
def test_restore_carries_every_committed_common(run):
    """Every committed `common` (read in place: restore only reads) into
    the port's state built from its snapshot: the parameters and BN
    statistics bit-equal to `load_trained_state`'s, every parameter's Adam
    moments equal to the reference's own read (orbax's `restore_raw`) of
    `mu` and `nu` converted, the count and the step equal, `best` the
    meta's. Then one update from seeded gradients against optax's
    `tx.update` on the same tree, within PARAM_TOL, at twice the run's
    epochs (the rate half of lr there, not the 0 of the run's end)."""
    assert len(COMMON_RUNS) == 12
    run_dir = os.path.join(CKPT, run)
    meta = _snapshot(run_dir)
    snapshot = meta["config"]
    raw = JaxCheckpoints(run_dir).restore_raw("common")
    step = int(raw["step"])
    epochs = snapshot["optim"]["num_epochs"]
    steps_per_epoch = step // epochs
    assert steps_per_epoch * epochs == step  # a run that ended where it meant to
    cfg, jcfg = _configs(snapshot, 2 * epochs)
    seg = _is_seg(snapshot)
    model = build_seg_model(cfg, 6) if seg else build_model(cfg)
    state = create_state(model, cfg, steps_per_epoch, CPU)
    assert CheckpointManager(run_dir).restore(state) == meta["best"]
    assert state.step == step

    want, _ = load_trained_state(run_dir)
    got = state.model.state_dict()
    assert got.keys() == want["model"].keys()
    for key, value in got.items():
        assert torch.equal(value, want["model"][key]), key
    decay, (adam, schedule) = raw["opt_state"]  # add_decayed_weights, then adam
    assert decay is None and int(adam["count"]) == int(schedule["count"]) == step
    stats = raw["batch_stats"]
    convert = from_flax_shapenet if seg else from_flax
    mu, nu = convert(adam["mu"], stats), convert(adam["nu"], stats)
    params = dict(state.model.named_parameters())
    for name, p in params.items():
        moments = state.optimizer.state[p]
        assert torch.equal(moments["exp_avg"], mu[name]), name
        assert torch.equal(moments["exp_avg_sq"], nu[name]), name
        assert moments["step"].device == CPU and moments["step"].dtype == torch.float32
        assert float(moments["step"]) == step

    grads = _seeded_grads(raw["params"], 0)
    tx = jax_make_optimizer(jcfg, steps_per_epoch)
    opt_state = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tx.init(raw["params"])),
        jax.tree_util.tree_leaves(raw["opt_state"]))
    updates, _ = tx.update(grads, opt_state, raw["params"])
    updated = convert(_np(optax.apply_updates(raw["params"], updates)), stats)
    for name, g in convert(grads, stats).items():
        if name in params:
            params[name].grad = g
    apply_update(state)
    moved = 0.0
    for name, p in params.items():
        assert float((p.detach() - updated[name]).abs().max()) <= PARAM_TOL, name
        moved = max(moved, float((p.detach() - want["model"][name]).abs().max()))
    assert moved >= 100 * PARAM_TOL  # the update is not lost in the tolerance


def test_resumed_tiny_train_matches_reference_resumed_train(tmp_path, monkeypatch):
    """checkpoints/common (tiny_smoke, step 8 of 16) copied twice: the
    port's train() against rift_tpu's, each resuming its copy for the
    second epoch, dropout off on both sides. Both log the resume from step
    8 (epoch 1), end at step 16 and log epoch 1 alone; the epoch's loss
    within LOSS_RTOL, the validation accuracy equal, the parameters and
    statistics by _held_after_epoch; the orbax copy unchanged."""
    cfg = _tiny_as_snapshot()
    jcfg = jax_config("tiny_smoke")
    for c, sub in ((cfg, "port"), (jcfg, "ref")):
        c.train.ckpt_dir = _copy_common(CKPT, str(tmp_path / sub))
        c.optim.num_epochs = 2
    before = _tree_sha256(os.path.join(cfg.train.ckpt_dir, "common"))
    create_state = t_loop.create_state

    def without_dropout(model, *args, **kwargs):
        model.dropout = 0.0
        return create_state(model, *args, **kwargs)

    monkeypatch.setattr(t_loop, "create_state", without_dropout)
    said, handler = _said(cfg.name)
    try:
        got = train(cfg, device="cpu")
    finally:
        get_logger(cfg.name).removeHandler(handler)
    with fnn.intercept_methods(_no_dropout):
        want = j_loop.train(jcfg)
    assert "resumed from step 8 (epoch 1)" in said
    assert got["state"].step == int(want["state"].step) == 16
    logs = {}
    for c in (cfg, jcfg):
        with open(os.path.join(c.train.ckpt_dir, "tiny_smoke.metrics.jsonl")) as f:
            logs[c.train.ckpt_dir] = [json.loads(line) for line in f]
    g, w = logs[cfg.train.ckpt_dir], logs[jcfg.train.ckpt_dir]
    assert [(r["epoch"], r["step"], r["split"]) for r in g] == \
        [(r["epoch"], r["step"], r["split"]) for r in w] == [(1, 16, "train"), (1, 16, "valid")]
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * want["loss"], (got["loss"], want["loss"])
    assert g[1]["acc"] == w[1]["acc"]
    rates = [got["state"].schedule(t) for t in range(8, 16)]
    _held_after_epoch(got["state"].model.state_dict(),
                      from_flax(_np(want["state"].params), _np(want["state"].batch_stats)), rates)
    assert _tree_sha256(os.path.join(cfg.train.ckpt_dir, "common")) == before
    assert os.path.isfile(os.path.join(cfg.train.ckpt_dir, "common.pt"))


def test_resume_finds_adam_behind_the_clip_state(tmp_path):
    """The reference trains one tiny epoch with optim.grad_clip and writes
    its orbax `common` (the chain clip, decay, adam); the port restores it
    (Adam's state found behind the clip's) and one clipped update from
    seeded gradients is held against optax's `tx.update` within PARAM_TOL."""
    _, jcfg = _tiny_configs()
    jcfg.train.ckpt_dir = str(tmp_path)
    jcfg.train.steps_per_epoch = 2
    jcfg.optim.num_epochs = 1
    jcfg.optim.grad_clip = 0.5
    j_loop.train(jcfg, resume=False)
    raw = JaxCheckpoints(str(tmp_path)).restore_raw("common")
    assert len(raw["opt_state"]) == 3 and raw["opt_state"][0] is None  # the clip's state

    snapshot = _snapshot(str(tmp_path))["config"]
    cfg, jcfg = _configs(snapshot, 2)
    assert cfg.optim.grad_clip == 0.5
    state = create_state(build_model(cfg), cfg, 2, CPU)
    CheckpointManager(str(tmp_path)).restore(state)
    assert state.step == 2
    grads = _seeded_grads(raw["params"], 1, scale=10.0)
    norm = float(optax.global_norm(grads))
    assert norm > 10 * cfg.optim.grad_clip  # the clip acts
    tx = jax_make_optimizer(jcfg, 2)
    opt_state = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tx.init(raw["params"])),
        jax.tree_util.tree_leaves(raw["opt_state"]))
    updates, _ = tx.update(grads, opt_state, raw["params"])
    stats = raw["batch_stats"]
    updated = from_flax(_np(optax.apply_updates(raw["params"], updates)), stats)
    params = dict(state.model.named_parameters())
    for name, g in from_flax(grads, stats).items():
        if name in params:
            params[name].grad = g
    apply_update(state)
    for name, p in params.items():
        assert float((p.detach() - updated[name]).abs().max()) <= PARAM_TOL, name


def test_own_resume_from_common_pt_is_exact(tmp_path):
    """Two epochs straight against one epoch, then a resume from
    `common.pt` for the second: the state dict, the Adam state, the step
    and the best metrics bit for bit. The rate is constant, so that the
    one-epoch run's schedule is the two-epoch run's."""
    runs = {}
    for tag, epochs in (("straight", (2,)), ("resumed", (1, 2))):
        cfg = get_config("tiny_smoke")
        cfg.train.ckpt_dir = str(tmp_path / tag)
        cfg.train.steps_per_epoch = 2
        cfg.dataset.synthetic_items = {"train": 8, "valid": 4, "test": 4}
        cfg.optim.schedule = "constant"
        for num_epochs in epochs:
            cfg.optim.num_epochs = num_epochs
            runs[tag] = train(cfg, device="cpu")
    a, b = runs["straight"], runs["resumed"]
    assert a["state"].step == b["state"].step == 4
    assert a["best"] == b["best"] and a["loss"] == b["loss"]
    sa, sb = a["state"].model.state_dict(), b["state"].model.state_dict()
    assert sa.keys() == sb.keys()
    for key in sa:
        assert torch.equal(sa[key], sb[key]), key
    oa, ob = a["state"].optimizer.state_dict(), b["state"].optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for i, moments in oa["state"].items():
        for key, value in moments.items():
            other = ob["state"][i][key]
            assert value.dtype == other.dtype and value.device == other.device
            assert torch.equal(value, other), (i, key)


def test_a_tree_of_other_widths_raises_naming_the_parameter():
    """The tiny `common` into a model whose first block is narrower: the
    restore names the first key that does not fit, and leaves the step."""
    cfg = _tiny_as_snapshot()
    cfg.model.blocks = ((8, 1, 8), (32, 1, None))
    state = create_state(build_model(cfg), cfg, 8, CPU)
    with pytest.raises(ValueError, match=r"layers\.PVConv_0\.convs\.0\.weight is "
                                         r"\(16, 67, 3, 3, 3\) in the checkpoint, "
                                         r"\(8, 67, 3, 3, 3\) in the model"):
        CheckpointManager(CKPT).restore(state)
    assert state.step == 0


def _tiny_adam_inputs():
    tree = read_orbax(os.path.join(CKPT, "common"))
    cfg = _tiny_as_snapshot()
    params = dict(build_model(cfg).named_parameters())
    return tree, params, lambda t: from_flax(t, tree["batch_stats"])


@pytest.mark.parametrize("case", ["no adam", "schedule count", "missing moment"])
def test_adam_from_flax_raises_on_a_tree_it_cannot_carry(case):
    """A chain with no Adam state, a schedule's count other than Adam's
    and the step, and a parameter without a moment each raise; the tree as
    committed carries."""
    tree, params, convert = _tiny_adam_inputs()
    count, moments = adam_from_flax(tree["opt_state"], 8, convert, params)
    assert count == 8 and moments.keys() == params.keys()
    decay, (adam, schedule) = tree["opt_state"]
    if case == "no adam":
        opt_state, match = [decay, [None, schedule]], "0 Adam states"
    elif case == "schedule count":
        opt_state, match = [decay, [adam, {"count": np.int32(7)}]], "count 7 differs"
    else:
        opt_state, match = tree["opt_state"], "no moment for the parameter head.Dense_2.bias"
        full = convert

        def convert(t):
            out = full(t)
            del out["head.Dense_2.bias"]
            return out
    with pytest.raises((KeyError, ValueError), match=match):
        adam_from_flax(opt_state, 8, convert, params)


def test_cli_train_resumes_from_orbax_then_from_common_pt(tmp_path):
    """`cli train` on a copy of checkpoints/common: it logs the resume from
    step 8 and writes `common.pt` beside the unchanged orbax `common/`; a
    second call resumes from `common.pt` at step 16 and trains no further;
    `--no-resume` starts at step 0."""
    ckpt = _copy_common(CKPT, str(tmp_path / "run"))
    assert checkpoint_exists(ckpt, "common") and not checkpoint_exists(str(tmp_path), "common")
    before = _tree_sha256(os.path.join(ckpt, "common"))
    args = [f"train.ckpt_dir={ckpt}", "optim.num_epochs=2", *TINY_AS_SNAPSHOT]
    argv = ["train", "--preset", "tiny_smoke", "--device", "cpu", *args]
    said, handler = _said("tiny_smoke")
    log = os.path.join(ckpt, "tiny_smoke.metrics.jsonl")
    try:
        assert cli.main(argv) == 0
        assert "resumed from step 8 (epoch 1)" in said
        assert os.path.isfile(os.path.join(ckpt, "common.pt"))
        assert _tree_sha256(os.path.join(ckpt, "common")) == before
        with open(log) as f:
            assert [json.loads(line)["step"] for line in f] == [16, 16]
        said.clear()
        assert cli.main(argv) == 0
        assert "resumed from step 16 (epoch 2)" in said
        with open(log) as f:
            assert len(f.readlines()) == 2  # nothing trained
        said.clear()
        assert cli.main(["train", "--preset", "tiny_smoke", "--device", "cpu", "--no-resume",
                         *args, "train.steps_per_epoch=2"]) == 0
        assert not any("resumed" in s for s in said)
        with open(log) as f:
            assert [json.loads(line)["epoch"] for line in f][2:] == [0, 0, 1, 1]
    finally:
        get_logger("tiny_smoke").removeHandler(handler)
    assert _tree_sha256(os.path.join(ckpt, "common")) == before


def test_resumed_segmentation_matches_reference_resume(tmp_path, monkeypatch):
    """A narrow `common` written by the reference's train_segmentation (one
    epoch of 2 steps at tiny_smoke's widths with the local branch, 8/4
    synthetic items of 64 points), copied twice and resumed for a second
    epoch by the port's train_segmentation and by the reference's, dropout
    off: step 4 on both, the epoch's loss within LOSS_RTOL and its mIoU
    within 1e-3 (tests/test_torch_seg.py's rules), the parameters and
    statistics by _held_after_epoch."""
    cfg, jcfg = _tiny_configs()
    for c in (cfg, jcfg):
        c.train.steps_per_epoch = 2
        c.optim.num_epochs = 1
    jcfg.train.ckpt_dir = str(tmp_path / "first")
    sn = JaxShapeNetConfig(num_points=64, synthetic_items=SEG_ITEMS)
    j_loop.train_segmentation(jcfg, sn, resume=False)
    for c, sub in ((cfg, "port"), (jcfg, "ref")):
        c.train.ckpt_dir = _copy_common(str(tmp_path / "first"), str(tmp_path / sub))
        c.optim.num_epochs = 2
    create_state = t_loop.create_state

    def without_dropout(model, *args, **kwargs):
        model.dropout = 0.0
        return create_state(model, *args, **kwargs)

    monkeypatch.setattr(t_loop, "create_state", without_dropout)
    got = train_segmentation(cfg, ShapeNetConfig(num_points=64, synthetic_items=SEG_ITEMS),
                             device="cpu")
    with fnn.intercept_methods(_no_dropout):
        want = j_loop.train_segmentation(jcfg, sn)
    assert got["state"].step == int(want["state"].step) == 4
    logs = {}
    for c in (cfg, jcfg):
        with open(os.path.join(c.train.ckpt_dir, f"{c.name}.metrics.jsonl")) as f:
            logs[c.train.ckpt_dir] = [json.loads(line) for line in f]
    g, w = logs[cfg.train.ckpt_dir], logs[jcfg.train.ckpt_dir]
    assert [(r["epoch"], r["step"]) for r in g] == [(r["epoch"], r["step"]) for r in w] == [(1, 4)]
    assert abs(g[0]["loss"] - w[0]["loss"]) <= LOSS_RTOL * w[0]["loss"], (g, w)
    assert abs(g[0]["iou"] - w[0]["iou"]) <= 1e-3, (g, w)
    rates = [got["state"].schedule(t) for t in range(2, 4)]
    _held_after_epoch(got["state"].model.state_dict(),
                      from_flax_shapenet(_np(want["state"].params),
                                         _np(want["state"].batch_stats)), rates)
