"""rift_tpu_torch's data-parallel training and sharded matching on the CPU:
4 gloo ranks (torch.multiprocessing.spawn, a file store in tmp_path) run
the sharded train step of tiny_smoke (f32 with and without dropout, and
the bf16 model) on a global batch of 8 and the sharded mutual nearest
neighbours; the results are held against the
port's single-process step, against rift_tpu's `make_distributed_step` on
the virtual 8-device mesh, and against `mutual_nearest_neighbors`."""
import dataclasses
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

from rift_tpu.ops.neighbors import mutual_nearest_neighbors as j_mutual_nn
from rift_tpu.train.loop import build_model as jax_build_model
from rift_tpu.train.loop import make_distributed_step as jax_make_distributed_step
from rift_tpu.parallel.mesh import replicate as jax_replicate
from rift_tpu.parallel.mesh import shard_batch as jax_shard_batch
from rift_tpu.train.steps import create_state as jax_create_state
from rift_tpu.train.steps import make_train_step
from rift_tpu_torch.ops.neighbors import mutual_nearest_neighbors
from rift_tpu_torch.parallel import make_sharded_train_step, shard_batch, sharded_mutual_nn
from rift_tpu_torch.train import build_model
from rift_tpu_torch.train.steps import (TrainState, forward_backward, make_optimizer,
                                        train_step)
from rift_tpu_torch.weights import from_flax
from test_torch_train import (BF16_FLOOR, BF16_LOSS_RTOL, BF16_RATIO, BF16_SLACK, BF16_ZERO_TOL,
                              GRAD_FLOOR, GRAD_ZERO_TOL, _no_dropout, _np, _tiny_configs)

WORLD = 4
GLOBAL_BATCH = 8
# The sharded steps each rank takes from the same weights: (tag, dropout,
# model.dtype).
RUNS = (("plain", 0.0, None), ("dropout", 0.2, None), ("bf16", 0.0, "bfloat16"))
SPAWN_TIMEOUT_S = 90  # the 4 ranks import torch, jax and the port, then take 2 steps
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


def _rank_main(rank: int, world: int, workdir: str) -> None:
    """One rank: the sharded step without and with dropout from the same
    weights, and the sharded mutual NN; its results saved as rank{r}.pt."""
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
        f1 = inputs["feat1"]
        rows = f1.shape[0] // world
        out["mnn"] = sharded_mutual_nn(f1[rank * rows:(rank + 1) * rows], inputs["feat2"])
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(workdir: str) -> list[dict]:
    """Run WORLD ranks of _rank_main; a rank that hangs fails the test
    after SPAWN_TIMEOUT_S (its processes are killed)."""
    ctx = mp.spawn(_rank_main, args=(WORLD, workdir), nprocs=WORLD, join=False)
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
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=True)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The reference's init of tiny_smoke (its create_state), a global
    batch of 8 clouds and two feature sets, run on 4 gloo ranks."""
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
    workdir = str(tmp_path_factory.mktemp("dp"))
    torch.save({"weights": weights, "clouds": torch.from_numpy(clouds),
                "labels": torch.from_numpy(labels), "feat1": torch.from_numpy(feat1),
                "feat2": torch.from_numpy(feat2)}, os.path.join(workdir, "inputs.pt"))
    ranks = _spawn(workdir)
    return dict(cfg=cfg, jcfg=jcfg, jmodel=jmodel, jstate=jstate, tx=tx, clouds=clouds,
                labels=labels, feat1=feat1, feat2=feat2, weights=weights, ranks=ranks)


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
