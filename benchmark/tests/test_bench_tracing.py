"""The seven readers of the program's spans and counters
(`rift_tpu_torch/tracing.py`): None without a trace, without the recorder
or without the entry; the value a call on a synthetic snapshot; and, on a
card, the counter `host.syncs` against the host syncs that CUDA's sync
debug mode reports in one call of each registration cell."""
from __future__ import annotations

import sys
import traceback
import warnings

import pytest

from benchmark import harness
from benchmark.trace import TraceSummary

SPANS = {"features_ms.register": "register.features", "local_ms.register": "pvcnn.local",
         "match_ms.register": "register.match", "pose_ms.register": "register.pose"}
COUNTERS = {"gnc_iterations.register": "gnc.iterations", "host_syncs.register": "host.syncs",
            "cuda_mallocs.register": "cuda.mallocs"}
READERS = [*SPANS, *COUNTERS]
CALLS = 4
SNAPSHOT = {
    "spans": {"register.features": {"count": 4, "host_s": 0.9, "host_self_s": 0.5,
                                    "device_s": 0.8, "parent": None},
              "pvcnn.local": {"count": 4, "host_s": 0.4, "host_self_s": 0.4,
                              "device_s": 0.3, "parent": "register.features"},
              "register.match": {"count": 4, "host_s": 0.02, "host_self_s": 0.02,
                                 "device_s": 0.04, "parent": None},
              "register.pose": {"count": 4, "host_s": 1.2, "host_self_s": 1.2,
                                "device_s": 1.0, "parent": None}},
    "counters": {"gnc.iterations": 400, "host.syncs": 0, "cuda.mallocs": 6},
    "launches": {}}
WANT = {"features_ms.register": 200.0, "local_ms.register": 75.0, "match_ms.register": 10.0,
        "pose_ms.register": 250.0, "gnc_iterations.register": 100.0,
        "host_syncs.register": 0.0, "cuda_mallocs.register": 1.5}


def _run(trace: TraceSummary | None) -> harness.Run:
    return harness.Run(harness.resolve("sph_dg_bf16.noise_b128"), harness.Window(), 1.0, 1,
                       "cpu", None, trace, [trace])


def _trace() -> TraceSummary:
    return TraceSummary(calls=CALLS, window_s=2.2, busy_s=0.6, launches=80000)


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
def test_reader_is_none_where_nothing_was_recorded(name, snapshot):
    snapshot({"spans": {}, "counters": {}, "launches": {}})
    assert harness.load_piece("metrics", name).read(_run(_trace())) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_without_its_entry(name, snapshot):
    """A span absent, or timed on no device, reads None; a counter never
    added to reads 0 beside recorded spans."""
    key = SPANS.get(name) or COUNTERS[name]
    snap = {"spans": {k: dict(v) for k, v in SNAPSHOT["spans"].items() if k != key},
            "counters": {k: v for k, v in SNAPSHOT["counters"].items() if k != key},
            "launches": {}}
    reader = harness.load_piece("metrics", name)
    snapshot(snap)
    assert reader.read(_run(_trace())) == (None if name in SPANS else 0.0)
    if name in SPANS:
        snap["spans"][key] = dict(SNAPSHOT["spans"][key], device_s=None)
        assert reader.read(_run(_trace())) is None


@pytest.mark.card
@pytest.mark.parametrize("cell", ["sph_dg_bf16.noise_b128", "mn40_sph_pt_f32.eval_teaser_b64"])
def test_host_syncs_count_every_sync_of_a_call(card, cell):
    """One call of the cell's program at its own size, traced, under sync
    debug mode "warn": the counter `host.syncs` equals the syncs reported,
    and every reported site is printed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rift_tpu_torch import tracing

    spec = harness.resolve(cell)
    built = harness.load_piece("drivers", spec.traffic["driver"]).build(
        harness.Context(spec, 2 ** 40 + 11, card))
    torch.cuda.synchronize()
    tracing.reset()
    sites: dict[str, int] = {}

    def seen(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return  # the mode's own notice, and any other warning
        ours = [f"{f.filename}:{f.lineno}" for f in traceback.extract_stack()[:-1]
                if "/rift_tpu_torch/" in f.filename]
        where = f"{filename}:{lineno} <- {' <- '.join(ours[::-1][:3])}: {str(message)[:120]}"
        sites[where] = sites.get(where, 0) + 1

    with warnings.catch_warnings(), profile(activities=[ProfilerActivity.CPU]):
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            built._run(built.src[0], built.dst[0])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counters = tracing.snapshot()["counters"]
    tracing.reset()
    syncs = sum(sites.values())
    print(f"\n{cell}: host.syncs {counters.get('host.syncs', 0)}, gnc.iterations "
          f"{counters.get('gnc.iterations')}, warnings {syncs}:")
    for where, n in sites.items():
        print(f"  {n} x {where}")
    built.release()
    assert counters.get("host.syncs", 0) == syncs
