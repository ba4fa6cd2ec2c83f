"""The port's span-and-counter recorder (`rift_tpu_torch/tracing.py`) on the
CPU: nothing recorded outside a profiler window; inside one, a
`register_batch` on 2 pairs of 128 points records its three stages once
each, the local branch under the features, GNC-TLS's iterations and host
reads on both schedules, as `cpu_op` ranges with no device time, and no
GNC graph replayed; the PCA frame's host read; self time is total time
less the children's; `train.profiling` is the same API. On a CUDA card
(marker `card`; `python -m pytest --noconftest -m card
tests/test_torch_tracing.py`), a traced fixed-schedule call replays
GNC-TLS's captured graph once."""
import importlib.util
import os
import time
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rift_tpu_torch import tracing
from rift_tpu_torch.data import SyntheticPairs
from rift_tpu_torch.models import PVCNNClassifier
from rift_tpu_torch.ops.cuda import kernel_wrappers
from rift_tpu_torch.ops.lrf import lrf_basis
from rift_tpu_torch.registration import register_batch
from rift_tpu_torch.train import profiling

STAGES = ("register.features", "register.match", "register.pose")
SCHEDULES = {"fixed": False, "exit": True}


@pytest.fixture(scope="module")
def batch():
    model = PVCNNClassifier(blocks=((8, 1, 4), (16, 1, None)), local_neighbors=8,
                            is_classify=False).eval()
    src, dst, _ = SyntheticPairs(num_pairs=2, num_points=128, seed=3).arrays()
    return model, src, dst


@pytest.fixture(scope="module")
def traced(batch):
    """Per schedule: the snapshot and the profiler's (name, activity type)
    of one traced register_batch."""
    out = {}
    for label, early_exit in SCHEDULES.items():
        tracing.reset()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            register_batch(*batch, device="cpu", early_exit=early_exit)
        events = [(e.name(), str(e.activity_type()))
                  for e in prof.profiler.kineto_results.events()]
        out[label] = (tracing.snapshot(), events)
    tracing.reset()
    return out


def test_register_batch_outside_a_profiler_records_nothing(batch):
    tracing.reset()
    register_batch(*batch, device="cpu", early_exit=True)
    snap = tracing.snapshot()
    assert snap["spans"] == {} and snap["counters"] == {}


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_traced_register_batch_records_each_stage_once(traced, schedule):
    spans = traced[schedule][0]["spans"]
    assert set(spans) == {*STAGES, "pvcnn.local"}
    assert all(spans[name]["count"] == 1 and spans[name]["parent"] is None for name in STAGES)
    local, features = spans["pvcnn.local"], spans["register.features"]
    assert local["count"] == 1 and local["parent"] == "register.features"
    assert 0 < local["host_s"] < features["host_s"]
    assert features["host_self_s"] == pytest.approx(features["host_s"] - local["host_s"])
    assert all(s["device_s"] is None for s in spans.values())  # no CUDA events on the CPU


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_traced_register_batch_counts_gnc_iterations_and_host_reads(traced, schedule):
    counters = traced[schedule][0]["counters"]
    iterations = counters["gnc.iterations"]
    if schedule == "fixed":
        assert iterations == 100 and counters.get("host.syncs", 0) == 0
    else:
        # One read before each iteration, and the one that ends the loop
        # when every pair stopped before the 100th.
        assert 0 < iterations <= 100
        assert counters["host.syncs"] == iterations + (iterations < 100)
    assert "cuda.mallocs" not in counters  # read on CUDA devices alone


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_traced_register_batch_on_the_cpu_replays_no_graph(traced, schedule):
    """GNC-TLS's captured graph replays on a CUDA device alone; the CPU runs
    the eager loop on both schedules."""
    counters = traced[schedule][0]["counters"]
    assert "gnc.graph_replays" not in counters and "gnc.graph_captures" not in counters
    assert counters["gnc.iterations"] == 100 or schedule == "exit"


READER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "benchmark", "metrics", "gnc_replays.register.py")


@pytest.mark.parametrize("calls, spans, counters, want", [
    (4, True, {"gnc.graph_replays": 4, "gnc.iterations": 400}, 1.0),
    (4, True, {"gnc.iterations": 224}, 0.0),  # the early exit: no replay
    (4, False, {}, None),  # nothing recorded in the window
    (None, True, {"gnc.graph_replays": 4}, None),  # no trace
], ids=["replayed", "eager", "unrecorded", "untraced"])
def test_gnc_replays_reader_reads_the_counter_a_call(monkeypatch, calls, spans, counters, want):
    """The benchmark's reader of `gnc.graph_replays` (`gnc_replays.register`)
    on a stand-in snapshot."""
    spec = importlib.util.spec_from_file_location("gnc_replays_register", READER)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    snap = {"spans": {"register.pose": {}} if spans else {}, "counters": counters,
            "launches": {}}
    monkeypatch.setattr(tracing, "snapshot", lambda: snap)
    run = SimpleNamespace(trace=None if calls is None else SimpleNamespace(calls=calls))
    assert reader.read(run) == want


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_traced_register_batch_on_the_card_replays_one_graph(batch, card):
    """On the card the fixed schedule's first call captures its graph; a
    traced call after it replays that graph once and captures nothing, and
    still counts the schedule's 100 iterations."""
    model, src, dst = batch
    model = model.to(card)
    src, dst = (torch.as_tensor(a, device=card) for a in (src, dst))
    try:
        register_batch(model, src, dst, device=card, early_exit=False)
        tracing.reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            register_batch(model, src, dst, device=card, early_exit=False)
        counters = tracing.snapshot()["counters"]
    finally:
        model.to("cpu")
        tracing.reset()
    assert counters.get("gnc.graph_replays") == 1
    assert counters.get("gnc.graph_captures", 0) == 0
    assert counters["gnc.iterations"] == 100


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_spans_are_cpu_ops_in_the_profilers_trace(traced, schedule):
    events = traced[schedule][1]
    for name in (*STAGES, "pvcnn.local"):
        kinds = [kind for n, kind in events if n == name]
        assert kinds == ["cpu_op"], (name, kinds)


@pytest.mark.parametrize("kind, reads", [("reference", 0), ("pca", 1)])
def test_lrf_basis_counts_its_host_reads(kind, reads):
    """The PCA frame's `eigh` reads its error codes on the host (a sync on
    a card); the reference frame reads nothing."""
    coords = torch.randn(2, 64, 3, generator=torch.Generator().manual_seed(0))
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        lrf_basis(coords, kind)
    counters = tracing.snapshot()["counters"]
    tracing.reset()
    assert counters.get("host.syncs", 0) == reads


def test_self_time_is_total_less_the_children():
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("outer"):
            time.sleep(0.002)
            for _ in range(2):
                with tracing.span("inner"):
                    time.sleep(0.003)
                    with tracing.span("leaf"):
                        time.sleep(0.001)
            tracing.count("probe", 3)
    spans = tracing.snapshot()["spans"]
    tracing.reset()
    outer, inner, leaf = spans["outer"], spans["inner"], spans["leaf"]
    assert (outer["count"], inner["count"], leaf["count"]) == (1, 2, 2)
    assert (outer["parent"], inner["parent"], leaf["parent"]) == (None, "outer", "inner")
    assert leaf["host_self_s"] == leaf["host_s"] >= 0.002
    assert inner["host_self_s"] == pytest.approx(inner["host_s"] - leaf["host_s"])
    assert outer["host_self_s"] == pytest.approx(outer["host_s"] - inner["host_s"])
    assert outer["host_self_s"] >= 0.002 and inner["host_self_s"] >= 0.006


@pytest.mark.parametrize("traced_window", [False, True], ids=["off", "on"])
def test_count_records_inside_a_profiler_alone(traced_window):
    tracing.reset()
    if traced_window:
        with profile(activities=[ProfilerActivity.CPU]):
            tracing.count("probe", 3)
            tracing.count("probe")
    else:
        tracing.count("probe", 3)
    counters = tracing.snapshot()["counters"]
    tracing.reset()
    assert counters == ({"probe": 4} if traced_window else {})


def test_snapshot_reads_the_kernel_launch_counts_without_moving_them():
    before = {name: fn.launches for name, fn in kernel_wrappers().items()}
    assert tracing.snapshot()["launches"] == before
    assert {name: fn.launches for name, fn in kernel_wrappers().items()} == before


@pytest.mark.parametrize("name", ["trace", "annotate", "StepTimer"])
def test_train_profiling_is_the_tracing_modules_api(name):
    assert getattr(profiling, name) is getattr(tracing, name)
