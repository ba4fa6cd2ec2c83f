"""Runs driven to their last line with the timed path broken underneath by
`control.planted`: `correct` comes out false for each fault a cell can have.
Registration: an answer altered where it is produced (the pose solve's
transforms moved); half of the batch left out (the later half of the pairs
never solved); the targets' features altered inside the forward, which the
pose check cannot see (the reference solves from the program's features).
Training: the state left unchanged (the update skipped); half of the batch
left out, the mean taken over the rest; on four ranks, the exchange between
them left out (the gradients not all-reduced)."""
from __future__ import annotations

import multiprocessing

import pytest

from benchmark import control, run
from benchmark.tests.conftest import tiny, tiny_dp
from benchmark.tests.test_bench_drivers import _args

REGISTRATION = ["sph_dg_bf16.noise_b128", "mn40_sph_pt_f32.eval_teaser_b64"]


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch"])
@pytest.mark.parametrize("cell", REGISTRATION)
def test_registration_fault_is_not_correct(cell, fault):
    spec = tiny(cell)
    with control.planted(fault, spec.traffic["pairs"]):
        out = run.run_rank(0, 1, _args(), spec, None, device_type="cpu")
    assert out["correct"] is False and out["checks"]["pose_gap"]["value"] > 0.0


@pytest.mark.parametrize("cell", REGISTRATION)
def test_targets_altered_in_the_forward_is_not_correct(cell):
    spec = tiny(cell)
    with control.planted("targets_altered", spec.traffic["pairs"]):
        out = run.run_rank(0, 1, _args(), spec, None, device_type="cpu")
    checks = out["checks"]
    assert out["correct"] is False, checks
    assert checks["features_off"]["value"] > checks["features_off"]["limit"], checks
    # The median cloud and the poses hold: only `features_off` sees it.
    assert checks["pose_gap"]["value"] == 0.0, checks
    if cell == "mn40_sph_pt_f32.eval_teaser_b64":
        assert checks["features_rel_median"]["value"] == 0.0, checks


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_training_fault_is_not_correct(fault):
    with control.planted(fault):
        out = run.run_rank(0, 1, _args(), tiny("mn40_sph_pt_f32.train_b16"), None,
                           device_type="cpu")
    assert out["correct"] is False, out["checks"]


def _rank_without_exchange(rank, world, spec, port, queue):
    with control.planted("exchange_left_out"):
        queue.put((rank, run.run_rank(rank, world, _args(seconds=0.5), spec, port,
                                      device_type="cpu")))


def test_data_parallel_without_the_exchange_is_not_correct():
    spec = tiny_dp()
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = run._free_port()
    procs = [ctx.Process(target=_rank_without_exchange, args=(r, 4, spec, port, queue))
             for r in range(4)]
    for p in procs:
        p.start()
    results = dict(queue.get(timeout=600) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive()
    assert results[0]["correct"] is False, results[0]["checks"]
