"""The segmentation cell (`shapenet_seg.train_b8_n2048`): `tiny` shrinks it;
its driver agrees with the reference at that size on the CPU (every gap
reads 0); a whole run up to its last line, traced; its planted faults come
out not correct; the readers of its spans and counters; its operation
count; and, on a card, its TF32 control comes out not correct."""
from __future__ import annotations

import json
import sys

import pytest

from benchmark import costs, costs_seg, faults_seg, harness, run, seg_clouds
from benchmark.tests.conftest import TINY_BLOCKS, TINY_TRAFFIC, tiny
from benchmark.tests.test_bench_drivers import _args, drive
from benchmark.trace import TraceSummary

CELL = "shapenet_seg.train_b8_n2048"
SPANS = {"forward_ms.train": "train.forward", "backward_ms.train": "train.backward",
         "local_ms.train": "pvcnn.local", "head_ms.seg": "seg.head"}
READERS = [*SPANS, "cuda_mallocs.train"]
CALLS = 4
SNAPSHOT = {
    "spans": {"train.forward": {"count": 4, "host_s": 0.2, "host_self_s": 0.1,
                                "device_s": 0.108, "parent": None},
              "pvcnn.local": {"count": 4, "host_s": 0.05, "host_self_s": 0.05,
                              "device_s": 0.026, "parent": "train.forward"},
              "seg.head": {"count": 4, "host_s": 0.05, "host_self_s": 0.05,
                           "device_s": 0.004, "parent": "train.forward"},
              "train.backward": {"count": 4, "host_s": 0.1, "host_self_s": 0.1,
                                 "device_s": 0.224, "parent": None},
              "train.update": {"count": 4, "host_s": 0.01, "host_self_s": 0.01,
                               "device_s": 0.0006, "parent": None}},
    "counters": {"cuda.mallocs": 2}, "launches": {}}
WANT = {"forward_ms.train": 27.0, "backward_ms.train": 56.0, "local_ms.train": 6.5,
        "head_ms.seg": 1.0, "cuda_mallocs.train": 0.5}


def test_tiny_shrinks_the_cell():
    spec, full = tiny(CELL), harness.resolve(CELL)
    assert spec.config["model"]["blocks"] == TINY_BLOCKS
    assert spec.config["model"]["local_neighbors"] == 16
    assert (spec.traffic["batch"], spec.traffic["points"]) == (TINY_TRAFFIC["batch"],
                                                              TINY_TRAFFIC["points"])
    assert full.traffic["batch"] == 8 and full.traffic["points"] == 2048
    assert full.config["model"]["local_neighbors"] == 128 and full.config["reduced"] == []


def test_driver_agrees_with_the_reference():
    checks = drive(tiny(CELL))
    assert checks and all(c.ok and c.value == 0.0 for c in checks), checks


def test_traced_run_line_reads_the_counter_and_no_device_span_on_the_cpu():
    """On the CPU the spans record no device time, so their readers are
    left out; the malloc counter reads 0 beside recorded spans."""
    spec = tiny(CELL)
    out = json.loads(json.dumps(run.run_rank(0, 1, _args(trace=1), spec, None,
                                             device_type="cpu")))
    assert out["correct"] is True and out["attempted"] >= 1
    assert set(out["metrics"]) == {"cuda_mallocs.train"}
    assert out["metrics"]["cuda_mallocs.train"]["value"] == 0.0
    assert {m["name"] for m in spec.per_layer} >= set(READERS) | {"mfu.seg"}


@pytest.mark.parametrize("fault", faults_seg.FAULTS)
def test_segmentation_fault_is_not_correct(fault):
    with faults_seg.planted(fault):
        out = run.run_rank(0, 1, _args(), tiny(CELL), None, device_type="cpu")
    assert out["correct"] is False and out["checks"]["loss1_gap"]["value"] > 0.0, out["checks"]


def test_shifted_parts_stay_inside_their_category():
    table = faults_seg.shifted_parts()
    assert sorted(table) == list(range(seg_clouds.NUM_PARTS))
    for offset, parts in zip(seg_clouds.OFFSETS, seg_clouds.PARTS):
        moved = table[offset:offset + parts]
        assert sorted(moved) == list(range(offset, offset + parts))
        assert all(m != offset + i for i, m in enumerate(moved))


def _run(trace: TraceSummary | None) -> harness.Run:
    return harness.Run(harness.resolve(CELL), harness.Window(), 1.0, 1, "cpu", None, trace,
                       [trace])


def _trace() -> TraceSummary:
    return TraceSummary(calls=CALLS, window_s=0.34, busy_s=0.32, launches=4000)


@pytest.fixture
def snapshot(monkeypatch):
    """Puts `snap` in place of the recorder's snapshot."""
    from rift_tpu_torch import tracing

    def put(snap):
        monkeypatch.setattr(tracing, "snapshot", lambda: snap)
    return put


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_the_value_a_call(name, snapshot):
    snapshot(SNAPSHOT)
    assert harness.load_piece("metrics", name).read(_run(_trace())) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_without_a_trace(name, snapshot):
    snapshot(SNAPSHOT)
    assert harness.load_piece("metrics", name).read(_run(None)) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_without_the_recorder(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "rift_tpu_torch.tracing", None)  # import raises
    monkeypatch.delattr("rift_tpu_torch.tracing", raising=False)
    assert harness.load_piece("metrics", name).read(_run(_trace())) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_without_its_entry(name, snapshot):
    """Nothing recorded reads None; a span absent, or timed on no device,
    reads None; the counter never added to reads 0 beside recorded spans."""
    reader = harness.load_piece("metrics", name)
    snapshot({"spans": {}, "counters": {}, "launches": {}})
    assert reader.read(_run(_trace())) is None
    key = SPANS.get(name, "cuda.mallocs")
    snap = {"spans": {k: dict(v) for k, v in SNAPSHOT["spans"].items() if k != key},
            "counters": {k: v for k, v in SNAPSHOT["counters"].items() if k != key},
            "launches": {}}
    snapshot(snap)
    assert reader.read(_run(_trace())) == (None if name in SPANS else 0.0)
    if name in SPANS:
        snap["spans"][key] = dict(SNAPSHOT["spans"][key], device_s=None)
        assert reader.read(_run(_trace())) is None


def test_mfu_seg_reads_three_forwards_over_the_traced_step():
    run_ = harness.Run(harness.resolve(CELL), harness.Window(), 1.0, 1,
                       "NVIDIA H100 80GB HBM3", None, _trace(), [_trace()])
    flops = 3 * costs_seg.forward_flops(run_.spec.config["model"], 8, 2048)
    want = 100.0 * flops / (0.34 / CALLS * 67e12)
    assert harness.load_piece("metrics", "mfu.seg").read(run_) == pytest.approx(want)
    assert harness.load_piece("metrics", "mfu.seg").read(_run(None)) is None


def test_seg_count_is_the_trunk_and_the_head():
    model = harness.resolve(CELL).config["model"]
    stages = {s.name: s.flops for s in costs_seg.seg_costs(model, 8, 2048)}
    trunk = costs.trunk_costs(dict(model, extra_feature_channels=4), 8, 2048)
    assert [s.name for s in trunk] == list(stages)[:5]
    assert stages["local_ppf"] == costs.cost_local_ppf(8, 2048, 128).flops
    assert stages["pvconv_r32_71->64"] == costs.cost_pvconv(8, 2048, 32, 71, 64, True).flops
    assert stages["mlp_1488->256"] == 2 * 8 * 2048 * 1488 * 256
    assert stages["mlp_128->50"] == 2 * 8 * 2048 * 128 * 50
    assert costs_seg.train_flops(model, 8, 2048) == 3 * sum(stages.values())


@pytest.mark.card
def test_tf32_control_is_not_correct_on_the_card(card):
    spec = tiny(CELL)
    spec.config["model"]["blocks"] = [[16, 1, 16], [32, 1, 16], [32, 1, None], [64, 1, None]]
    built = harness.load_piece("drivers", spec.traffic["driver"]).build(
        harness.Context(spec, 2 ** 40 + 9, card, program="control"))
    first = built.calls_in_setup
    for i in range(first, first + 4):
        built.call(i)
    built.release()
    checks = built.check()
    assert not all(c.ok for c in checks), checks
