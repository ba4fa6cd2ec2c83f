"""rift_tpu_torch's data-parallel training and sharded matching on the CPU:
4 gloo ranks (torch.multiprocessing.spawn, a file store in tmp_path) run
the sharded train step of tiny_smoke (f32 with and without dropout, and
the bf16 model) on a global batch of 8, the sharded step of the part
segmentation model (with and without its per-point dropout) on 8 ShapeNet
items, and the sharded mutual nearest neighbours; the results are held
against the port's single-process step, against rift_tpu's
`make_distributed_step` on the virtual 8-device mesh (the classifier's
step, and the segmentation step of its `train_segmentation`), and against
`mutual_nearest_neighbors`. The ranks also run `train_segmentation`
together, held against its single-process run. A batch size the ranks do
not divide trains each rank alone. In a second spawn the 4 ranks run the
sequence's sharded solves (`optimize_pose_graph_sharded`,
`bundle_adjust_sharded`) and `map_sequence` with the group, held within
1e-3 of the single solves and of the single-process map."""
import dataclasses
import json
import logging
import os
import time

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from rift_tpu.models import ShapeNetPVCNN as JaxShapeNetPVCNN
from rift_tpu.ops.neighbors import mutual_nearest_neighbors as j_mutual_nn
from rift_tpu.train.loop import build_model as jax_build_model
from rift_tpu.train.loop import make_distributed_step as jax_make_distributed_step
from rift_tpu.parallel.mesh import replicate as jax_replicate
from rift_tpu.parallel.mesh import shard_batch as jax_shard_batch
from rift_tpu.train.steps import TrainState as JaxTrainState
from rift_tpu.train.steps import create_state as jax_create_state
from rift_tpu.train.steps import make_optimizer as jax_make_optimizer
from rift_tpu.train.steps import make_train_step
from rift_tpu_torch.data.shapenet import ShapeNet, ShapeNetConfig
from rift_tpu_torch.models import ShapeNetPVCNN
from rift_tpu_torch.ops.neighbors import mutual_nearest_neighbors
from rift_tpu_torch.parallel import make_sharded_train_step, shard_batch, sharded_mutual_nn
from rift_tpu_torch.train import build_model, make_distributed_step, train_segmentation
from rift_tpu_torch.train.steps import TrainState, forward_backward, make_optimizer, train_step
from rift_tpu_torch.train.utils import get_logger
from rift_tpu_torch.weights import from_flax, from_flax_shapenet
from test_torch_seg import _ref_seg_step, _reference_weights
from test_torch_train import (BF16_FLOOR, BF16_LOSS_RTOL, BF16_RATIO, BF16_SLACK, BF16_ZERO_TOL,
                              GRAD_FLOOR, GRAD_RTOL, GRAD_ZERO_TOL, LOSS_RTOL, SETTLED_PARAM_TOL,
                              STATS_TOL, _no_dropout, _np, _tiny_configs)

WORLD = 4
GLOBAL_BATCH = 8
# The sharded steps each rank takes from the same weights: (tag, dropout,
# model.dtype).
RUNS = (("plain", 0.0, None), ("dropout", 0.2, None), ("bf16", 0.0, "bfloat16"))
# The segmentation model's sharded steps: (tag, dropout).
SEG_RUNS = (("seg_plain", 0.0), ("seg_dropout", 0.2))
SEG_MODEL = dict(blocks=((16, 1, 8), (32, 1, None)), local_neighbors=16, with_local_feat=True)
# The segmentation model's f32 gradients miss the f64 ones by up to ~2.5e-3
# of their norm in both the single-process and the sharded step (the local
# branch's BatchNorm over the PPF angles, arccos of near-parallel normals),
# so the two steps' sums in another order land either side of each other:
# a sharded gradient is held within SEG_GRAD_RATIO times the single step's
# distance from the f64 gradient (or DP_GRAD_RTOL of its norm). Measured:
# ratios up to 1.42 (the first PVConv's point-branch BatchNorm scale),
# where the single step's distance is 2.1e-3 of the norm.
SEG_GRAD_RATIO = 2.0
SPAWN_TIMEOUT_S = 90  # the 4 ranks import torch, jax and the port, then take 9 steps
DROPOUT_SEED = 7
# The port's 4-rank step against its single-process step on the same
# global batch: the same function, the global BatchNorm statistics
# combined from the ranks' (Chan's form) and the gradients summed over the
# ranks, so only the order of the sums differs; the inputs are
# ill-conditioned (tests/test_torch_train.py), which amplifies that.
DP_LOSS_RTOL = 1e-5      # measured 3.0e-6 (1.3e-5 on a loss of 4.24)
DP_STATS_TOL = 2e-6      # of the largest running statistic; measured 9.0e-7
DP_PARAM_TOL = 1e-6      # absolute, where the step's gradient is settled; measured 3.0e-7
# Gradients against the f64 gradient of the same step: a parameter whose
# f64 gradient has a norm of at least GRAD_FLOOR of the largest
# (tests/test_torch_train.py) is held to it at least as closely as the
# single-process f32 step is, or within DP_GRAD_RTOL of its norm (measured:
# the single step 2.1e-6..2.2e-2, the PVConv coefficient the largest; the
# sharded step 1.1e-7..1.7e-4); the others within GRAD_ZERO_TOL of the
# largest norm.
DP_GRAD_RTOL = 1e-5
# A parameter element whose single-process gradient is rounding (a bias in
# front of a train-mode BatchNorm has a gradient of exactly 0 in exact
# arithmetic) gets Adam's first step of ±lr from the sign of that rounding,
# so it may land up to 2·lr away (tests/test_torch_train.py's rule): an
# element is settled where its two gradients agree within SETTLED of the
# single-process gradient's magnitude.
SETTLED = 1e-2
# Against rift_tpu's sharded step on the 8-device mesh: the tolerances of
# tests/test_parallel.py:test_dp_single_step_equivalence.
REF_LOSS_TOL, REF_STATS_RTOL, REF_STATS_ATOL = 1e-4, 1e-3, 1e-5
# The reference's f32 segmentation gradients on the 8 × 64 batch miss the
# f64 gradient of the same step by up to 1.05e-2 of its norm on the mesh
# (1.40e-2 on one device; a BatchNorm bias of the first PVConv), the port's
# sharded ones by at most 1.75e-3: the rounding of the ill-conditioned
# local branch (SEG_GRAD_RATIO's comment), not a difference of functions.
REF_SEG_GRAD_RTOL = 2e-2


def _seg_config(ckpt_dir: str):
    """train-seg of tiny_smoke on the synthetic ShapeNet split at 64
    points, one epoch of 2 steps."""
    cfg, _ = _tiny_configs()
    cfg.train.ckpt_dir = ckpt_dir
    cfg.dataset.num_points = 64
    cfg.optim.num_epochs = 1
    cfg.train.steps_per_epoch = 2
    return cfg


def _rank_main(rank: int, world: int, workdir: str) -> None:
    """One rank: the sharded steps without and with dropout from the same
    weights, the sharded mutual NN and `train_segmentation`; its results
    saved as rank{r}.pt."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(workdir, 'store')}",
                            rank=rank, world_size=world)
    try:
        inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=True)
        cfg, _ = _tiny_configs()
        out = {}
        for tag, dropout, dtype in RUNS:
            model = build_model(dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model, dtype=dtype)))
            model.load_state_dict(inputs["weights"])
            model.dropout = dropout
            state = TrainState(model, *make_optimizer(model, cfg, 1))
            clouds, labels = shard_batch((inputs["clouds"], inputs["labels"]))
            gen = torch.Generator().manual_seed(DROPOUT_SEED)
            metrics = make_sharded_train_step()(state, clouds, labels, gen)
            out[tag] = {"loss": metrics["loss"], "acc": metrics["acc"],
                        "state": model.state_dict(),
                        "grads": {n: p.grad for n, p in model.named_parameters()}}
        for tag, dropout in SEG_RUNS:
            model = ShapeNetPVCNN(**SEG_MODEL)
            model.load_state_dict(inputs["seg_weights"])
            model.dropout = dropout
            state = TrainState(model, *make_optimizer(model, cfg, 1))
            clouds, labels = shard_batch((inputs["seg_clouds"], inputs["seg_labels"]))
            gen = torch.Generator().manual_seed(DROPOUT_SEED)
            metrics = make_sharded_train_step()(state, clouds, labels, gen)
            out[tag] = {"loss": metrics["loss"], "acc": metrics["acc"],
                        "state": model.state_dict(),
                        "grads": {n: p.grad for n, p in model.named_parameters()}}
        step, group = make_distributed_step(True, GLOBAL_BATCH + 2)
        out["indivisible_alone"] = step is train_step and group is None
        f1 = inputs["feat1"]
        rows = f1.shape[0] // world
        out["mnn"] = sharded_mutual_nn(f1[rank * rows:(rank + 1) * rows], inputs["feat2"])
        seg_cfg = _seg_config(os.path.join(workdir, "train_seg"))
        said = []
        handler = logging.Handler()
        handler.emit = lambda record: said.append(record.getMessage())
        get_logger(seg_cfg.name).addHandler(handler)
        out["train_seg"] = train_segmentation(seg_cfg, resume=False, device="cpu")["best"]
        out["train_seg_said"] = said
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(workdir: str, main=_rank_main, saved: str = "rank") -> list[dict]:
    """Run WORLD ranks of `main`, then load what each saved as
    `{saved}{rank}.pt`; a rank that hangs fails the test after
    SPAWN_TIMEOUT_S (its processes are killed)."""
    ctx = mp.spawn(main, args=(WORLD, workdir), nprocs=WORLD, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                pytest.fail(f"the {WORLD} ranks did not finish in {SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert not any(p.is_alive() for p in ctx.processes)
    return [torch.load(os.path.join(workdir, f"{saved}{r}.pt"), weights_only=True)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The reference's init of tiny_smoke (its create_state) and of the
    narrow segmentation model, a global batch of 8 clouds, one of 8
    ShapeNet items and two feature sets, run on 4 gloo ranks."""
    cfg, jcfg = _tiny_configs()
    r = np.random.RandomState(0)
    clouds = r.randn(GLOBAL_BATCH, cfg.dataset.num_points, 6).astype(np.float32)
    labels = r.randint(0, 40, (GLOBAL_BATCH,)).astype(np.int32)
    feat1 = r.randn(64, 16).astype(np.float32)
    feat1[40] = feat1[3]  # two rows at one place: a column's tie across ranks
    feat2 = r.randn(48, 16).astype(np.float32)
    feat2[[7, 9]] = feat1[[3, 20]]  # exact minima, one of them tied
    jmodel = jax_build_model(jcfg)
    jstate, tx = jax_create_state(jmodel, jcfg, jnp.asarray(clouds), steps_per_epoch=1)
    weights = from_flax(_np(jstate.params), _np(jstate.batch_stats))
    seg_clouds, seg_labels = next(ShapeNet(ShapeNetConfig(
        num_points=64, synthetic_items={"train": GLOBAL_BATCH, "test": 1}), "train").batches(
        GLOBAL_BATCH, seed=0))
    jseg = JaxShapeNetPVCNN(**SEG_MODEL)
    jseg_params, jseg_stats = _reference_weights(jseg, seg_clouds, seed=jcfg.seed)
    seg_weights = from_flax_shapenet(jseg_params, jseg_stats)
    workdir = str(tmp_path_factory.mktemp("dp"))
    torch.save({"weights": weights, "clouds": torch.from_numpy(clouds),
                "labels": torch.from_numpy(labels), "feat1": torch.from_numpy(feat1),
                "feat2": torch.from_numpy(feat2), "seg_weights": seg_weights,
                "seg_clouds": torch.from_numpy(seg_clouds),
                "seg_labels": torch.from_numpy(seg_labels)},
               os.path.join(workdir, "inputs.pt"))
    ranks = _spawn(workdir)
    return dict(cfg=cfg, jcfg=jcfg, jmodel=jmodel, jstate=jstate, tx=tx, clouds=clouds,
                workdir=workdir,
                labels=labels, feat1=feat1, feat2=feat2, weights=weights, ranks=ranks,
                seg_weights=seg_weights, seg_clouds=seg_clouds, seg_labels=seg_labels,
                jseg=jseg, jseg_params=jseg_params, jseg_stats=jseg_stats)


def _single(run: dict, dropout: float, dtype=torch.float32,
            model_dtype: str | None = None) -> tuple[dict, TrainState]:
    """train_step on the whole batch in `dtype` (f64: the gradients only),
    of the model of `model_dtype`."""
    cfg = run["cfg"]
    model = build_model(dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dtype=model_dtype)))
    model.load_state_dict(run["weights"])
    model.dropout = dropout
    model.to(dtype)
    state = TrainState(model, *make_optimizer(model, cfg, 1))
    gen = torch.Generator().manual_seed(DROPOUT_SEED)
    step = train_step if dtype == torch.float32 else forward_backward
    out = step(state, torch.from_numpy(run["clouds"]).to(dtype),
               torch.from_numpy(run["labels"]), gen)
    return out, state


def test_every_rank_holds_the_same_state(dp_run):
    first = dp_run["ranks"][0]
    for other in dp_run["ranks"][1:]:
        for tag, _, _ in RUNS:
            assert float(other[tag]["loss"]) == float(first[tag]["loss"])
            assert float(other[tag]["acc"]) == float(first[tag]["acc"])
            for k, v in first[tag]["state"].items():
                assert torch.equal(other[tag]["state"][k], v), (tag, k)


@pytest.mark.parametrize("tag, dropout", [("plain", 0.0), ("dropout", 0.2)])
def test_sharded_step_matches_the_single_process_step(dp_run, tag, dropout):
    """Loss, accuracy, BatchNorm statistics, gradients and parameters of
    rank 0 against train_step on the whole batch; with dropout, the ranks'
    rows of one global mask are the single-process mask."""
    out, state = _single(dp_run, dropout)
    got = dp_run["ranks"][0][tag]
    assert abs(float(got["loss"]) - float(out["loss"])) <= DP_LOSS_RTOL * float(out["loss"])
    assert float(got["acc"]) == float(out["acc"])
    want = state.model.state_dict()
    stats = [k for k in want if "running" in k]
    scale = max(float(want[k].abs().max()) for k in stats)
    for k in stats:
        assert float((got["state"][k] - want[k]).abs().max()) <= DP_STATS_TOL * scale, k
    _, exact = _single(dp_run, dropout, torch.float64)
    g64 = {n: p.grad for n, p in exact.model.named_parameters()}
    top = max(float(g.norm()) for g in g64.values())
    lr = state.schedule(0)
    for name, p in state.model.named_parameters():
        g, want_g = got["grads"][name].double(), g64[name]
        err = float((g - want_g).norm())
        if float(want_g.norm()) >= GRAD_FLOOR * top:
            single_err = float((p.grad.double() - want_g).norm())
            assert err <= max(single_err, DP_GRAD_RTOL * float(want_g.norm())), \
                (name, err / float(want_g.norm()), single_err / float(want_g.norm()))
        else:
            assert err <= GRAD_ZERO_TOL * top, (name, err / top)
        off = (got["state"][name] - p.detach()).abs()
        settled = (got["grads"][name] - p.grad).abs() <= SETTLED * p.grad.abs()
        assert float(torch.where(settled, off, 0.0).max()) <= DP_PARAM_TOL, name
        assert float(off.max()) <= 2.1 * lr, name


def test_sharded_bf16_step_is_as_accurate_as_the_single_process_step(dp_run):
    """The bf16 model's sharded step: its gradients are as close to the f64
    gradient as the single-process bf16 step's are (tests/test_torch_train
    .py's bf16 rule: BF16_FLOOR, BF16_RATIO, BF16_SLACK, BF16_ZERO_TOL), its
    loss within BF16_LOSS_RTOL of that step's, its parameters f32."""
    out, state = _single(dp_run, 0.0, model_dtype="bfloat16")
    got = dp_run["ranks"][0]["bf16"]
    assert abs(float(got["loss"]) - float(out["loss"])) <= BF16_LOSS_RTOL * float(out["loss"])
    _, exact = _single(dp_run, 0.0, torch.float64)
    g64 = {n: p.grad for n, p in exact.model.named_parameters()}
    top = max(float(g.norm()) for g in g64.values())
    held = 0
    for name, p in state.model.named_parameters():
        want = g64[name]
        err = float((got["grads"][name].double() - want).norm())
        if float(want.norm()) >= BF16_FLOOR * top:
            single_err = float((p.grad.double() - want).norm())
            assert err <= BF16_RATIO * single_err + BF16_SLACK * float(want.norm()), \
                (name, err / float(want.norm()), single_err / float(want.norm()))
            held += 1
        else:
            assert err <= BF16_ZERO_TOL * top, (name, err / top)
        assert got["state"][name].dtype == torch.float32
    assert held >= 10


def test_sharded_step_matches_reference_make_distributed_step(dp_run):
    """Rank 0's step (dropout off) against rift_tpu's data-parallel step of
    the same batch on the 8-device mesh (dropout off), with the tolerances
    of tests/test_parallel.py."""
    jmodel, jstate = dp_run["jmodel"], dp_run["jstate"]
    step = make_train_step(jmodel, dp_run["tx"])
    dp_step, mesh = jax_make_distributed_step(step, True, GLOBAL_BATCH)
    assert mesh is not None and len(mesh.devices.flat) == 8
    with fnn.intercept_methods(_no_dropout):
        j_state, j_metrics = dp_step(jax_replicate(mesh, jstate),
                                     jax_shard_batch(mesh, jnp.asarray(dp_run["clouds"])),
                                     jax_shard_batch(mesh, jnp.asarray(dp_run["labels"])),
                                     jax_replicate(mesh, jax.random.PRNGKey(0)))
    got = dp_run["ranks"][0]["plain"]
    assert abs(float(got["loss"]) - float(j_metrics["loss"])) < REF_LOSS_TOL
    assert float(got["acc"]) == float(j_metrics["acc"])
    want = from_flax(_np(j_state.params), _np(j_state.batch_stats))
    stats = [k for k in want if "running" in k]
    assert len(stats) == len(jax.tree_util.tree_leaves(j_state.batch_stats))
    for k in stats:
        np.testing.assert_allclose(got["state"][k].numpy(), want[k].numpy(),
                                   rtol=REF_STATS_RTOL, atol=REF_STATS_ATOL, err_msg=k)


def test_sharded_mutual_nn_equals_mutual_nearest_neighbors(dp_run):
    """The ranks' rows concatenated equal the single-process mutual NN and
    the reference's, exactly, ties included."""
    parts = [r["mnn"] for r in dp_run["ranks"]]
    idx1, idx2, mask = (torch.cat([p[i] for p in parts]) for i in range(3))
    f1, f2 = torch.from_numpy(dp_run["feat1"]), torch.from_numpy(dp_run["feat2"])
    w1, w2, wm = mutual_nearest_neighbors(f1, f2)
    assert torch.equal(idx1, w1) and torch.equal(idx2, w2) and torch.equal(mask, wm)
    j1, j2, jm = j_mutual_nn(jnp.asarray(dp_run["feat1"]), jnp.asarray(dp_run["feat2"]))
    np.testing.assert_array_equal(idx2.numpy(), np.asarray(j2))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    assert bool(mask[3]) != bool(mask[40])  # the tied rows: the lower one is the mutual match


def _single_seg(run: dict, dropout: float, dtype=torch.float32) -> tuple[dict, TrainState]:
    """The segmentation model's train_step on the whole batch in `dtype`
    (f64: the gradients only)."""
    model = ShapeNetPVCNN(**SEG_MODEL)
    model.load_state_dict(run["seg_weights"])
    model.dropout = dropout
    model.to(dtype)
    state = TrainState(model, *make_optimizer(model, run["cfg"], 1))
    gen = torch.Generator().manual_seed(DROPOUT_SEED)
    step = train_step if dtype == torch.float32 else forward_backward
    out = step(state, torch.from_numpy(run["seg_clouds"]).to(dtype),
               torch.from_numpy(run["seg_labels"]), gen)
    return out, state


@pytest.mark.parametrize("tag, dropout", SEG_RUNS)
def test_sharded_seg_step_matches_the_single_process_step(dp_run, tag, dropout):
    """The segmentation model's sharded step on 4 ranks (2 items each):
    every rank holds the same state; rank 0's loss (the mean over all
    8·64 points), per-point accuracy, BN statistics, gradients and
    parameters against train_step on the whole batch, by the rules of the
    classifier's test above (the gradients by SEG_GRAD_RATIO); with
    dropout, the ranks' rows of the global
    [8, 64, 256] masks are the single-process masks."""
    ranks = dp_run["ranks"]
    for other in ranks[1:]:
        assert float(other[tag]["loss"]) == float(ranks[0][tag]["loss"])
        for k, v in ranks[0][tag]["state"].items():
            assert torch.equal(other[tag]["state"][k], v), k
    out, state = _single_seg(dp_run, dropout)
    got = ranks[0][tag]
    assert abs(float(got["loss"]) - float(out["loss"])) <= DP_LOSS_RTOL * float(out["loss"])
    assert abs(float(got["acc"]) - float(out["acc"])) <= 1e-6
    want = state.model.state_dict()
    stats = [k for k in want if "running" in k]
    scale = max(float(want[k].abs().max()) for k in stats)
    for k in stats:
        assert float((got["state"][k] - want[k]).abs().max()) <= DP_STATS_TOL * scale, k
    _, exact = _single_seg(dp_run, dropout, torch.float64)
    g64 = {n: p.grad for n, p in exact.model.named_parameters()}
    top = max(float(g.norm()) for g in g64.values())
    lr = state.schedule(0)
    for name, p in state.model.named_parameters():
        g, want_g = got["grads"][name].double(), g64[name]
        err = float((g - want_g).norm())
        if float(want_g.norm()) >= GRAD_FLOOR * top:
            single_err = float((p.grad.double() - want_g).norm())
            assert err <= max(SEG_GRAD_RATIO * single_err, DP_GRAD_RTOL * float(want_g.norm())), \
                (name, err / float(want_g.norm()), single_err / float(want_g.norm()))
        else:
            assert err <= GRAD_ZERO_TOL * top, (name, err / top)
        off = (got["state"][name] - p.detach()).abs()
        settled = (got["grads"][name] - p.grad).abs() <= SETTLED * p.grad.abs()
        assert float(torch.where(settled, off, 0.0).max()) <= DP_PARAM_TOL, name
        assert float(off.max()) <= 2.1 * lr, name


def test_sharded_seg_step_matches_reference_make_distributed_step(dp_run):
    """Rank 0's segmentation step (dropout off) against the reference's:
    rift_tpu's train_segmentation step (`seg_step`, in its data-parallel
    wrapper) through `make_distributed_step` on the 8-device mesh, dropout
    off, from the same init and batch; the loss (the mean over all 8·64
    points), the BN statistics and the updated parameters by the rules of
    tests/test_torch_seg.py's single-process step; the gradients against
    the f64 gradient of the same step (the port's `forward_backward` in
    f64 on the whole batch): the reference's within REF_SEG_GRAD_RTOL of
    it, which pins the two functions to each other, and the port's at least
    as close as the reference's (or within DP_GRAD_RTOL)."""
    jmodel, params = dp_run["jseg"], dp_run["jseg_params"]
    tx = jax_make_optimizer(dp_run["jcfg"], 1)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=dp_run["jseg_stats"], opt_state=tx.init(params))
    seg_step = _ref_seg_step(jmodel, tx)

    def seg2(state, clouds, labels, rng):  # the reference's `_seg2`, with the gradients
        new_state, loss, grads = seg_step(state, clouds, labels, rng)
        return new_state, {"loss": loss, "grads": grads}

    dp_step, mesh = jax_make_distributed_step(seg2, True, GLOBAL_BATCH)
    assert mesh is not None and len(mesh.devices.flat) == 8
    with fnn.intercept_methods(_no_dropout):
        j_state, j_metrics = dp_step(jax_replicate(mesh, jstate),
                                     jax_shard_batch(mesh, jnp.asarray(dp_run["seg_clouds"])),
                                     jax_shard_batch(mesh, jnp.asarray(dp_run["seg_labels"])),
                                     jax_replicate(mesh, jax.random.PRNGKey(0)))
    got = dp_run["ranks"][0]["seg_plain"]
    np.testing.assert_allclose(float(got["loss"]), float(j_metrics["loss"]), rtol=LOSS_RTOL)
    stats = _np(j_state.batch_stats)
    want = from_flax_shapenet(_np(j_state.params), stats)
    jgrads = from_flax_shapenet(_np(j_metrics["grads"]), stats)
    running = [k for k in want if "running" in k]
    assert len(running) == len(jax.tree_util.tree_leaves(j_state.batch_stats))
    scale = max(float(want[k].abs().max()) for k in running)
    for k in running:
        assert float((got["state"][k] - want[k]).abs().max()) <= STATS_TOL * scale, k
    _, exact = _single_seg(dp_run, 0.0, torch.float64)
    g64 = {n: p.grad for n, p in exact.model.named_parameters()}
    top = max(float(g.norm()) for g in g64.values())
    _, schedule = make_optimizer(ShapeNetPVCNN(**SEG_MODEL), dp_run["cfg"], 1)
    lr = schedule(0)
    for name, g in got["grads"].items():
        want_g, exact_g = jgrads[name], g64[name]
        norm = float(exact_g.norm())
        if norm >= GRAD_FLOOR * top:
            ref_err = float((want_g.double() - exact_g).norm())
            assert ref_err <= REF_SEG_GRAD_RTOL * norm, (name, ref_err / norm)
            err = float((g.double() - exact_g).norm())
            assert err <= max(ref_err, DP_GRAD_RTOL * norm), (name, err / norm, ref_err / norm)
        else:
            assert float((g - want_g).norm()) <= GRAD_ZERO_TOL * top, name
        off = (got["state"][name] - want[name]).abs()
        settled = (g - want_g).abs() <= SETTLED * want_g.abs()
        assert float(torch.where(settled, off, 0.0).max()) <= SETTLED_PARAM_TOL, name
        assert float(off.max()) <= 2.1 * lr, (name, float(off.max()) / lr)


def test_train_segmentation_on_the_ranks_is_data_parallel(dp_run, tmp_path):
    """train_segmentation on the 4 ranks (one item of the global batch of
    4 each, as each rank logs): rank 0 alone writes the metric log and the
    checkpoints, the
    epoch's loss is within DP_LOSS_RTOL of the single-process run's and
    every rank holds the mIoU that rank 0 evaluated, within 1e-3 of the
    single-process run's (the same state up to the order of the sums)."""
    ckpt = os.path.join(dp_run["workdir"], "train_seg")
    with open(os.path.join(ckpt, "tiny_smoke.metrics.jsonl")) as f:
        dp = [json.loads(line) for line in f]
    assert len(dp) == 1 and dp[0]["step"] == 2
    assert {"common.pt", "best_iou.pt"} <= set(os.listdir(ckpt))
    for r in dp_run["ranks"]:
        assert "data-parallel over 4 ranks (gloo)" in r["train_seg_said"]
        assert r["train_seg"] == {"iou": dp[0]["iou"]}
    single_dir = str(tmp_path / "single")
    best = train_segmentation(_seg_config(single_dir), resume=False, device="cpu")["best"]
    with open(os.path.join(single_dir, "tiny_smoke.metrics.jsonl")) as f:
        single = [json.loads(line) for line in f]
    assert abs(dp[0]["loss"] - single[0]["loss"]) <= DP_LOSS_RTOL * single[0]["loss"]
    assert abs(dp[0]["iou"] - best["iou"]) <= 1e-3


def test_a_batch_the_ranks_do_not_divide_trains_each_rank_alone(dp_run):
    assert all(r["indivisible_alone"] for r in dp_run["ranks"])


# --- The sequence's sharded solves -------------------------------------

SEQ_TOL = 1e-3  # tests/test_pose_graph.py:78-97,137-146 and tests/test_sequence.py:104-106
SEQ_MAP_KW = dict(noise_bound=0.08, loop_stride=4, landmarks_per_edge=16, batch_edges=8, seed=0)


def _seq_rank_main(rank: int, world: int, workdir: str) -> None:
    """One rank: its shard of the pose graph's edges and of BA's landmarks
    (padded as the sequence pads them), the two sharded solves, and
    map_sequence with the group; its results saved as seq{r}.pt."""
    from rift_tpu_torch.parallel import bundle_adjust_sharded, optimize_pose_graph_sharded
    from rift_tpu_torch.registration.sequence import map_sequence, pad_to_multiple

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(workdir, 'store')}",
                            rank=rank, world_size=world)
    try:
        inp = torch.load(os.path.join(workdir, "seq_inputs.pt"), weights_only=False)
        pg = pad_to_multiple([inp["i_idx"], inp["j_idx"], inp["meas"], inp["w"]], world,
                             [np.int32(0), np.int32(0), np.eye(4, dtype=np.float32),
                              np.float32(0.0)])
        shard = shard_batch(pg)
        graph = optimize_pose_graph_sharded(torch.from_numpy(inp["init"]),
                                            *map(torch.from_numpy, shard), num_iterations=8)
        k = inp["obs_pose"].shape[1]
        ba = pad_to_multiple([inp["lms"], inp["obs_pose"], inp["obs_local"]], world,
                             [np.zeros(3, np.float32), -np.ones(k, np.int32),
                              np.zeros((k, 3), np.float32)])
        edges = tuple(map(torch.from_numpy, inp["edges"]))
        poses, lms = bundle_adjust_sharded(torch.from_numpy(inp["poses"]),
                                           *map(torch.from_numpy, shard_batch(ba)),
                                           num_iterations=5, edges=edges)
        m = map_sequence(inp["scans"], inp["feats"], gt_poses=inp["gt"], group=dist.group.WORLD,
                         device="cpu", **SEQ_MAP_KW)
        torch.save({"graph": graph, "poses": poses, "lms": lms,
                    "map_graph": torch.from_numpy(m.graph), "map_ba": torch.from_numpy(m.ba),
                    "ate_ba": torch.tensor(m.metrics["ate_ba"], dtype=torch.float64)},
                   os.path.join(workdir, f"seq{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def seq_run(tmp_path_factory):
    """A drifting pose graph of 6 nodes (its 8 edges do not split over 4
    ranks), a BA problem of 66 landmarks joint with 4 edges, and the
    oracle-feature sequence of 8 scans x 128 points, on 4 gloo ranks."""
    from test_pose_graph import _make_ba_problem, _make_trajectory

    from rift_tpu_torch.data.sequences import SequenceConfig, SyntheticSequence

    rng = np.random.RandomState(0)
    gt, i_idx, j_idx, meas = _make_trajectory(rng, 6, drift=0.02)
    gt_poses, gt_lms, obs_pose, obs_local = _make_ba_problem(rng, num_landmarks=66, noise=0.01)
    lms = (gt_lms + rng.randn(*gt_lms.shape) * 0.05).astype(np.float32)
    e_i, e_j = np.array([0, 1, 2, 0], np.int32), np.array([1, 2, 3, 3], np.int32)
    rel = np.stack([np.linalg.inv(gt_poses[a]) @ gt_poses[b]
                    for a, b in zip(e_i, e_j)]).astype(np.float32)
    seq = SyntheticSequence(SequenceConfig(num_scans=8, num_points=128, scene_points=2048,
                                           seed=4))
    feats = np.stack([s @ p[:3, :3].T + p[:3, 3] for s, p in zip(seq.scans, seq.gt_poses)])
    inp = dict(init=np.stack([np.eye(4, dtype=np.float32)] * 6), i_idx=i_idx, j_idx=j_idx,
               meas=meas, w=np.ones(len(i_idx), np.float32), poses=gt_poses, lms=lms,
               obs_pose=obs_pose, obs_local=obs_local,
               edges=(e_i, e_j, rel, np.array([10.0, 20.0, 5.0, 1.0], np.float32)),
               scans=seq.scans, feats=feats.astype(np.float32), gt=seq.gt_poses)
    workdir = str(tmp_path_factory.mktemp("seq_dp"))
    torch.save(inp, os.path.join(workdir, "seq_inputs.pt"))
    return inp, _spawn(workdir, _seq_rank_main, "seq")


def test_sharded_pose_graph_matches_the_single_solve(seq_run):
    from rift_tpu_torch.registration import optimize_pose_graph

    inp, ranks = seq_run
    single = optimize_pose_graph(*(torch.from_numpy(inp[k])
                                   for k in ("init", "i_idx", "j_idx", "meas", "w")),
                                 num_iterations=8)
    for r in ranks:
        torch.testing.assert_close(r["graph"], ranks[0]["graph"], rtol=0, atol=0)
        np.testing.assert_allclose(r["graph"].numpy(), single.numpy(), rtol=0, atol=SEQ_TOL)


def test_sharded_bundle_adjust_matches_the_single_solve(seq_run):
    """Poses on every rank, and the ranks' landmark shards put back
    together (the padding dropped), within SEQ_TOL of the single solve."""
    from rift_tpu_torch.registration import bundle_adjust

    inp, ranks = seq_run
    poses, lms = bundle_adjust(*(torch.from_numpy(inp[k])
                                 for k in ("poses", "lms", "obs_pose", "obs_local")),
                               num_iterations=5, edges=tuple(map(torch.from_numpy, inp["edges"])))
    assert not torch.equal(lms, torch.from_numpy(inp["lms"]))  # the guard accepted
    for r in ranks:
        np.testing.assert_allclose(r["poses"].numpy(), poses.numpy(), rtol=0, atol=SEQ_TOL)
    gathered = torch.cat([r["lms"] for r in ranks])[:lms.shape[0]]
    np.testing.assert_allclose(gathered.numpy(), lms.numpy(), rtol=0, atol=SEQ_TOL)


def test_map_sequence_on_the_ranks_matches_one_process(seq_run):
    from rift_tpu_torch.registration.sequence import map_sequence

    inp, ranks = seq_run
    single = map_sequence(inp["scans"], inp["feats"], gt_poses=inp["gt"], device="cpu",
                          **SEQ_MAP_KW)
    for r in ranks:
        np.testing.assert_allclose(r["map_graph"].numpy(), single.graph, rtol=0, atol=SEQ_TOL)
        np.testing.assert_allclose(r["map_ba"].numpy(), single.ba, rtol=0, atol=SEQ_TOL)
        assert abs(float(r["ate_ba"]) - single.metrics["ate_ba"]) < SEQ_TOL
