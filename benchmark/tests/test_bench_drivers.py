"""Each driver against the reference at a small size on the CPU (the port's
kernels run their plain versions there, so every gap reads 0), a whole run
up to its last line, and the four-rank data-parallel run over gloo."""
from __future__ import annotations

import argparse
import json
import math
import multiprocessing

import pytest
import torch

from benchmark import harness, run
from benchmark.tests.conftest import tiny, tiny_dp

SINGLE = ["sph_dg_bf16.noise_b128", "mn40_sph_pt_f32.train_b16",
          "mn40_sph_pt_f32.eval_teaser_b64"]


def drive(spec, program="port", calls=4, seed=2 ** 40 + 3):
    """Build the cell on the CPU, run `calls` calls, release, check."""
    cell = harness.load_piece("drivers", spec.traffic["driver"]).build(
        harness.Context(spec, seed, torch.device("cpu"), program=program))
    first = getattr(cell, "calls_in_setup", 0)
    for i in range(first, first + calls):
        cell.call(i)
    cell.release()
    return cell.check()


@pytest.mark.parametrize("cell", SINGLE)
def test_driver_agrees_with_the_reference(cell):
    checks = drive(tiny(cell))
    assert checks and all(c.ok and c.value == 0.0 for c in checks), checks


def test_fp8_control_is_not_correct():
    checks = {c.name: c for c in drive(tiny("sph_dg_bf16.noise_b128"), "control")}
    assert not checks["features_rel_median"].ok, checks


def _args(seconds=0.3, trace=0, seed=5):
    return argparse.Namespace(workload="x", seed=seed, seconds=seconds, trace=trace)


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_shape(trace):
    spec = tiny("sph_dg_bf16.noise_b128")
    out = run.run_rank(0, 1, _args(trace=trace), spec, None, device_type="cpu")
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert line["device"]["platform"] == "cpu" and line["device"]["count"] == 1
    want = spec.per_layer if trace else spec.end_to_end
    if trace:
        assert set(line["metrics"]) <= {m["name"] for m in want}
        assert line["device"]["window_s"] > 0 and set(line["breakdown"]) == {"device_ops",
                                                                             "idle_gaps"}
    else:
        assert set(line["metrics"]) == {m["name"] for m in want}
    assert all(math.isfinite(m["value"]) for m in line["metrics"].values())
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())


def _rank(rank, world, spec, port, queue):
    out = run.run_rank(rank, world, _args(seconds=0.5), spec, port, device_type="cpu")
    queue.put((rank, out))


def test_data_parallel_run_on_four_gloo_ranks():
    spec = tiny_dp()
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = run._free_port()
    procs = [ctx.Process(target=_rank, args=(r, 4, spec, port, queue)) for r in range(4)]
    for p in procs:
        p.start()
    results = dict(queue.get(timeout=600) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    line = results[0]
    assert all(results[r] is None for r in (1, 2, 3))
    assert line["correct"] and line["device"]["count"] == 4, line
    assert line["metrics"]["clouds_per_s"]["value"] > 0
