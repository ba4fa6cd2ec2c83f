"""`BENCHMARK.json` against the contract's form, and every cell built from
its files; a cell added as files alone is found."""
from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = json.load(open(harness.MANIFEST))
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = ([c["name"] for c in MANIFEST["configs"]] + CELLS
             + [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and set(m) <= {"name", "unit", "better", "source", "layer",
                                               "moves", "workloads"}
        assert all(w in CELLS for w in m.get("workloads", []))
    four = [w for w in MANIFEST["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_builds_from_its_files(cell):
    spec = harness.resolve(cell)
    assert spec.chips in (1, 4)
    assert os.path.isfile(os.path.join(harness.BENCH_DIR, "drivers",
                                       f"{spec.traffic['driver']}.py"))
    for m in spec.end_to_end + spec.per_layer:
        assert hasattr(harness.load_piece("metrics", m["name"]), "read")
    names = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and spec.per_layer
    assert spec.limits and all(v >= 0 for v in spec.limits.values())


@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_configuration_file_holds_what_runs(config):
    path = os.path.join(harness.ROOT, config["file"])
    assert path.startswith(os.path.join(harness.BENCH_DIR, "configs"))
    body = json.load(open(path))
    assert body["name"] == config["name"] and body["reduced"] == config["reduced"]
    assert body["lower_precision"] in ("tf32", "fp8")


def test_a_cell_added_as_files_alone_is_found(tmp_path, monkeypatch):
    """A copy of the benchmark with one more traffic mix, limits file and
    manifest entry: the new cell resolves with no code edited."""
    bench = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["workloads"].append({"name": "sph_dg_bf16.noise_b64", "config": "sph_dg_bf16",
                                  "traffic": "noise_b64", "chips": 1, "why": "a new mix"})
    manifest["end_to_end"][0]["workloads"].append("sph_dg_bf16.noise_b64")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    traffic = json.load(open(bench / "traffic" / "noise_b128.json"))
    traffic["pairs"] = 64
    (bench / "traffic" / "noise_b64.json").write_text(json.dumps(traffic))
    shutil.copy(bench / "limits" / "sph_dg_bf16.noise_b128.json",
                bench / "limits" / "sph_dg_bf16.noise_b64.json")
    monkeypatch.setattr(harness, "BENCH_DIR", str(bench))
    monkeypatch.setattr(harness, "ROOT", str(tmp_path))
    spec = harness.resolve("sph_dg_bf16.noise_b64", str(tmp_path / "BENCHMARK.json"))
    assert spec.traffic["pairs"] == 64 and spec.config["name"] == "sph_dg_bf16"
    assert [m["name"] for m in spec.end_to_end] == ["pairs_per_s", "setup_s"]


def test_the_four_card_cell_resolves_from_its_files(tmp_path):
    """The data-parallel cell's driver, traffic, limits and `nccl_ms.train`
    resolve from their files under a manifest entry. Its limits are the
    one-card cell's, not yet set from four-card readings."""
    manifest = json.loads(json.dumps(MANIFEST))
    cell = "mn40_sph_pt_f32.train_dp4_b16"
    manifest["workloads"].append({"name": cell, "config": "mn40_sph_pt_f32",
                                  "traffic": "train_dp4_b16", "chips": 4, "why": "4 cards"})
    manifest["end_to_end"][2]["workloads"].append(cell)
    manifest["per_layer"].append({"name": "nccl_ms.train", "unit": "ms", "better": "lower",
                                  "source": "device_trace", "layer": "parallel",
                                  "moves": "clouds_per_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    spec = harness.resolve(cell, str(tmp_path / "BENCHMARK.json"))
    assert spec.chips == 4 and spec.traffic["driver"] == "train_step_dp"
    assert [m["name"] for m in spec.per_layer] == ["nccl_ms.train"]
    assert spec.limits == harness.resolve("mn40_sph_pt_f32.train_b16").limits
    for m in spec.end_to_end + spec.per_layer:
        assert hasattr(harness.load_piece("metrics", m["name"]), "read")
