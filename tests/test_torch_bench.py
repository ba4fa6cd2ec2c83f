"""bench_torch.py, the twin of bench.py, on the CPU: its JSON line with
every key of bench.py's line plus the card's name and power limit, its
transforms against register_batch's (with either GNC-TLS schedule), the
BENCH_KERNEL and BENCH_FLAGSHIP switches, the sph_pt series being
bench.py's bf16 model and not the f32 flagship, the denominator's file,
and the card as the default device."""
import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch

from rift_tpu_torch.data import SyntheticPairs
from rift_tpu_torch.registration import register_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bench.py:155-175's keys, and the two flagship keys its default run adds.
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "kernel", "stack",
              "stacked_pairs_per_s", "one_batch_pairs_per_s", "flagship_kernel",
              "flagship_stacked_pairs_per_s", "vs_baseline_note"]
SMALL = {"BENCH_POINTS": "128", "BENCH_PAIRS": "2", "BENCH_STACK": "2"}


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: the suite runs 6 workers on the host's cores,
    and the solvers' thousands of small ops a call stall on a contended
    thread pool (a 1.5 s test took 95 s under the suite's load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _narrow(kernel: str = "dgcnn"):
    """bench_model(kernel) at narrow widths (spherical r = 8, blocks 16/32,
    local k = 16) with every other field of bench.py's model: the runs
    below test the script, at a cost the suite can carry (the full model's
    32³ bf16 convolutions take minutes on a shared CPU)."""
    from rift_tpu_torch.models import PVCNNClassifier

    return PVCNNClassifier(
        blocks=((16, 1, 8), (32, 1, 8), (32, 1, None)), dim_k=32, is_classify=False,
        point_kernel_formal=kernel + "_kernel", voxel_shape="spherical",
        rot_invariant_preprocess="change_coords", lrf_kind="reference", with_local_feat="ppf",
        extra_feature_channels=4, local_neighbors=16, with_coeff=True, with_se=True,
        dtype="bfloat16")


def _load():
    spec = importlib.util.spec_from_file_location("bench_torch", os.path.join(ROOT, "bench_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def bench():
    return _load()


@pytest.fixture
def small_env(monkeypatch):
    for key in ("BENCH_KERNEL", "BENCH_FLAGSHIP", "BENCH_GNC_EARLY_EXIT"):
        monkeypatch.delenv(key, raising=False)
    for key, value in SMALL.items():
        monkeypatch.setenv(key, value)


def _line(bench, capsys, argv=("--device", "cpu")) -> dict:
    assert bench.main(list(argv)) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def test_cpu_run_prints_bench_py_keys_with_finite_values(bench, small_env, monkeypatch, capsys,
                                                         tmp_path):
    """The whole script at BENCH_POINTS=128, BENCH_PAIRS=2, BENCH_STACK=2
    on the CPU (the model at narrow widths): one line, bench.py's keys in
    its order, then device, gpu and power_limit (null on the CPU); every
    rate finite and positive; vs_baseline null without
    BASELINE_MEASURED_H100.json, and the note says why."""
    monkeypatch.setattr(bench, "bench_model", _narrow)
    monkeypatch.setattr(bench, "BASELINE_FILE", str(tmp_path / "BASELINE_MEASURED_H100.json"))
    out = _line(bench, capsys)
    assert list(out) == BENCH_KEYS + ["device", "gpu", "power_limit"]
    for key in ("value", "stacked_pairs_per_s", "one_batch_pairs_per_s",
                "flagship_stacked_pairs_per_s"):
        assert math.isfinite(out[key]) and out[key] > 0, key
    assert out["value"] == out["stacked_pairs_per_s"]
    assert (out["kernel"], out["flagship_kernel"], out["stack"], out["unit"]) == \
        ("sph_dg", "sph_pt", 2, "pairs/s")
    assert out["metric"].startswith("registered scan-pairs/s") and "128-pt" in out["metric"]
    assert out["vs_baseline"] is None
    assert "BASELINE_MEASURED_H100.json" in out["vs_baseline_note"]
    assert "default dgcnn/1024pt/64pair" in out["vs_baseline_note"]
    assert (out["device"], out["gpu"], out["power_limit"]) == ("cpu", None, None)


def test_vs_baseline_reads_the_h100_hosts_file(bench, tmp_path, monkeypatch):
    """The denominator is BASELINE_MEASURED_H100.json's pairs_per_s; the
    reference's BASELINE_MEASURED.json (measured on the TPU's host) is not
    read, and a missing file gives None, never a constant."""
    path = tmp_path / "BASELINE_MEASURED_H100.json"
    monkeypatch.setattr(bench, "BASELINE_FILE", str(path))
    assert bench._baseline_pairs_per_s() is None
    path.write_text(json.dumps({"pairs_per_s": 12.5}))
    assert bench._baseline_pairs_per_s() == 12.5
    assert os.path.basename(_load().BASELINE_FILE) == "BASELINE_MEASURED_H100.json"


@pytest.mark.parametrize("env, measured, flagship", [
    ({}, [("dgcnn", 6), ("dgcnn", 1), ("pointnet", 6)], True),
    ({"BENCH_FLAGSHIP": "0"}, [("dgcnn", 6), ("dgcnn", 1)], False),
    ({"BENCH_KERNEL": "pointnet"}, [("pointnet", 6), ("pointnet", 1)], False),
])
def test_kernel_and_flagship_switches_act_as_in_bench_py(bench, monkeypatch, capsys, env,
                                                        measured, flagship):
    """bench.py:127-175's control flow, with _measure counted: the series
    kernel stacked and one batch at a time, then the sph_pt series only
    after a dgcnn series and unless BENCH_FLAGSHIP=0; the flagship keys
    only when it ran; the note whenever BENCH_KERNEL is set."""
    for key in ("BENCH_POINTS", "BENCH_PAIRS", "BENCH_STACK", "BENCH_KERNEL", "BENCH_FLAGSHIP"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(bench, "BASELINE_FILE", os.devnull + ".missing")
    calls = []

    def counted(kernel, src, dst, batch_pairs, stack, device=None):
        calls.append((kernel, stack))
        assert src.shape == dst.shape == (64, 1024, 3) and batch_pairs == 64
        return 100.0 * stack, None

    monkeypatch.setattr(bench, "_measure", counted)
    monkeypatch.setattr(bench, "SyntheticPairs", _Stub)
    out = _line(bench, capsys)
    assert calls == measured
    assert ("flagship_kernel" in out) == flagship == ("flagship_stacked_pairs_per_s" in out)
    assert out["kernel"] == ("sph_pt" if env.get("BENCH_KERNEL") == "pointnet" else "sph_dg")
    assert (out["value"], out["one_batch_pairs_per_s"]) == (600.0, 100.0)
    note = out["vs_baseline_note"]
    assert ("default dgcnn/1024pt/64pair" in note) == ("BENCH_KERNEL" in env)


class _Stub:
    """SyntheticPairs' arguments checked against bench.py's, arrays of its
    shapes without the shapes' cost."""

    def __init__(self, num_pairs, num_points, mode, max_amp):
        assert (mode, max_amp) == ("noise", 0.5)
        self.shape = (num_pairs, num_points, 3)

    def arrays(self):
        return np.zeros(self.shape, np.float32), np.zeros(self.shape, np.float32), None


def test_flagship_series_is_bench_models_bf16_pointnet(bench):
    """bench.py:_make_model('pointnet'): the bf16 bench model with the
    PointNet point kernel, not the f32 mn40_sph_pt_r4 model; both series'
    weights drawn from the seed 0, the same on every call."""
    from rift_tpu_torch.models import bench_model
    from rift_tpu_torch.train import get_config

    flagship = bench._make_model("pointnet", torch.device("cpu"))
    series = bench._make_model("dgcnn", torch.device("cpu"))
    assert not flagship.layers["PVConv_0"].dgcnn and series.layers["PVConv_0"].dgcnn
    for m in (flagship, series):
        assert not m.training and m.lrf_kind == "reference" and m.local_neighbors == 128
        assert m.dtype == torch.bfloat16
    f32 = get_config("mn40_sph_pt_r4").model
    assert f32.dtype is None and f32.lrf_kind == "pca"  # the f32 flagship is another model
    want = bench_model("pointnet").state_dict()
    got = flagship.state_dict()
    assert list(got) == list(want) and all(got[k].shape == want[k].shape for k in got)
    again = bench._make_model("pointnet", torch.device("cpu")).state_dict()
    assert all(torch.equal(got[k], again[k]) for k in got)


@pytest.fixture(scope="module")
def pairs():
    src, dst, _ = SyntheticPairs(num_pairs=2, num_points=128, mode="noise", max_amp=0.5).arrays()
    return src, dst


def test_measure_transforms_are_register_batchs(bench, pairs, monkeypatch):
    """_measure's last timed stack (stack 2) with BENCH_GNC_EARLY_EXIT=0
    (GNC-TLS's fixed schedule) is register_batch on the stack's inputs
    with the early exit, bit for bit: the stack's offsets and either
    schedule give the same transforms (the model at narrow widths)."""
    src, dst = pairs
    monkeypatch.setattr(bench, "bench_model", _narrow)
    monkeypatch.setenv("BENCH_GNC_EARLY_EXIT", "0")
    rate, est = bench._measure("dgcnn", src, dst, 2, 2, "cpu")
    assert rate > 0 and est.shape == (2, 2, 4, 4)
    model = bench._make_model("dgcnn", torch.device("cpu"))
    s = torch.as_tensor(src)
    stack = torch.stack([s + 1e-4 * i for i in range(2)]) + 1e-4 * (bench.REPS - 1)
    for i in range(2):
        want = register_batch(model, stack[i], dst, device="cpu")
        assert torch.equal(est[i], want), i


def test_device_none_is_the_card_and_raises_without_one(bench, pairs, small_env):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    src, dst = pairs
    with pytest.raises(RuntimeError, match="CUDA"):
        bench._measure("dgcnn", src, dst, 2, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])
