"""The benchmark's machinery, driven by `BENCHMARK.json` and files found by
name:

- `configs/<name>.json`: a configuration (the file that `configs[].file`
  names);
- `traffic/<name>.json`: a traffic mix; its `driver` key names the entry
  driver;
- `drivers/<name>.py`: an entry driver, `build(ctx)` -> a cell object with
  `units_per_call`, `call(i)` (one call, returned once its answers are on
  the host), `release()` (frees the program's state) and `check()` (the
  comparison with the reference, a list of `common.Check`);
- `metrics/<name>.py`: one metric, `read(run)` -> a number, or None where
  the run holds nothing to read;
- `limits/<cell>.json`: the limit of each number a cell compares.

A later change adds a configuration, a mix, a cell or a metric by adding
such files and entries, and edits none of these.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "rift_tpu")
STOP_EVERY = 8  # calls between the ranks' agreements on going on, on several cards


@dataclass
class CellSpec:
    """One workload of the manifest with everything it names."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str, cell_e2e: set[str]) -> bool:
    """Whether `cell` reports `metric`: its `workloads` name the cell, or it
    has none and (for a per-layer metric) the cell reports what it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in cell_e2e


def resolve(name: str, manifest_path: str = MANIFEST) -> CellSpec:
    """The cell `name` of the manifest, with its configuration, traffic and
    limits read from their files."""
    manifest = _read_json(manifest_path)
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in {manifest_path} (known: {sorted(work)})")
    w = work[name]
    cfg = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    config = _read_json(os.path.join(ROOT, cfg["file"]))
    traffic = _read_json(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"))
    limits = _read_json(os.path.join(BENCH_DIR, "limits", f"{name}.json"))
    e2e = [m for m in manifest["end_to_end"] if reports(m, name, set())]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"] if reports(m, name, names)]
    return CellSpec(name, int(w["chips"]), config, traffic, limits, e2e, layer)


def load_piece(kind: str, name: str):
    """The module `<kind>/<name>.py` of the benchmark (a driver or a metric)."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cache_environment(root: str = ROOT) -> dict:
    """Fixed cache directories inside the checkout for what the program or
    its libraries compile (the program's own kernels build in
    `rift_tpu_torch/_build`)."""
    cache = os.path.join(root, ".bench_cache")
    return {"TRITON_CACHE_DIR": os.path.join(cache, "triton"),
            "TORCH_EXTENSIONS_DIR": os.path.join(cache, "torch_extensions"),
            "CUDA_CACHE_PATH": os.path.join(cache, "cuda")}


@dataclass
class Context:
    """What a driver is built from."""
    spec: CellSpec
    seed: int
    device: object  # torch.device
    rank: int = 0
    world: int = 1
    group: object = None  # the NCCL process group on several chips
    program: str = "port"  # "port", or "control": the reference one step below


@dataclass
class Window:
    """The measured window: each call's host start and end (s) and units."""
    starts: list[float] = field(default_factory=list)
    ends: list[float] = field(default_factory=list)
    units: list[int] = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.ends[-1] - self.starts[0] if self.ends else 0.0

    @property
    def latencies(self) -> list[float]:
        return [e - s for s, e in zip(self.starts, self.ends)]


def run_window(cell, seconds: float, first: int, sync, keep_going=None,
               max_calls: int | None = None) -> Window:
    """Closed loop, one call in flight: calls `first`, `first` + 1, ... back
    to back until `seconds` have passed since the first began (or
    `max_calls` are done). `sync()` waits for the device (and, on several
    chips, the other ranks) before the window opens; `keep_going(bool)`
    turns rank 0's decision into every rank's, asked every STOP_EVERY
    calls so that the agreement costs the steps little."""
    from torch.profiler import record_function

    win = Window()
    sync()
    t0 = time.perf_counter()
    i = first
    while True:
        s = time.perf_counter()
        with record_function("bench.call"):
            cell.call(i)
        win.starts.append(s)
        win.ends.append(time.perf_counter())
        win.units.append(cell.units_per_call)
        i += 1
        more = win.ends[-1] - t0 < seconds and (max_calls is None or len(win.ends) < max_calls)
        if keep_going is not None:
            more = True if len(win.ends) % STOP_EVERY else keep_going(more)
        if not more:
            break
    sync()
    return win


@dataclass
class Run:
    """What the metric readers read."""
    spec: CellSpec
    window: Window
    setup_s: float
    chips: int
    device_name: str
    power_limit: str | None
    trace: object = None  # trace.TraceSummary of rank 0, with --trace 1
    traces: list = field(default_factory=list)  # every rank's


def read_metrics(run: Run, metrics: list[dict]) -> dict:
    """Each metric's reader on the run; those that return None are left out."""
    out = {}
    for m in metrics:
        value = load_piece("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _number(x: float):
    """A JSON number, or the value's name where it is not finite."""
    return x if math.isfinite(x) else str(x)


def result(run: Run, checks: list, metrics: dict, memory_peak: int) -> dict:
    """The run's result line: `correct`, `attempted` (calls in the window),
    `failed` (comparisons over their limits), `metrics`, `device` (with the
    traced seconds, averaged over the cards), `breakdown` when traced, and
    last `checks`, each number beside its limit."""
    dev = {"platform": "cpu" if run.device_name == "cpu" else "gpu",
           "kind": run.device_name, "count": run.chips,
           "memory_peak_bytes": int(memory_peak), "power_limit": run.power_limit}
    failed = sum(1 for c in checks if not c.ok)
    out = {"correct": bool(checks) and failed == 0, "attempted": len(run.window.ends),
           "failed": failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = sum(t.busy_s for t in run.traces) / len(run.traces)
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {c.name: {"value": _number(c.value), "limit": c.limit} for c in checks}
    return out
