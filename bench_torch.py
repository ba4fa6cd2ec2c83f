"""Benchmark: registered scan-pairs/s on one CUDA card for the full
two-stage pipeline, the twin of bench.py on rift_tpu_torch.

Measures end-to-end registration throughput: per-point rotation-invariant
features (bench.py's bf16 PVCNN extractor, sph_dg by default, 1024
points) -> mutual-NN matching -> GNC-TLS robust pose, batched on the card
(`registration/pipeline.py:register_batch`, which is bench.py's
`register_batch`).

Methodology, as bench.py's: a STACK of 6 batches of 64 pairs is one unit
of work; its batches are enqueued back to back, 3 stacks (the inputs
nudged by 1e-4 each) are enqueued after one warm-up stack, and one
torch.cuda.synchronize() ends them: the number is sustained throughput
including all host overhead. GNC-TLS's early exit reads `active.any()`
on the host every iteration (`registration/gnc.py`), so consecutive
batches overlap only in part; BENCH_GNC_EARLY_EXIT=0 runs its fixed
100-iteration schedule instead, to the same transforms. The one-batch
figure is the same at a stack of 1.

The model's weights are flax's default initializers drawn from a
torch.Generator seeded with 0 (`train/steps.py:init_params`), as bench.py
initializes its model from PRNGKey(0).

Prints ONE JSON line with bench.py's keys ("metric", "value", "unit",
"vs_baseline", "kernel", "stack", "stacked_pairs_per_s",
"one_batch_pairs_per_s", "flagship_kernel" and
"flagship_stacked_pairs_per_s" when the sph_pt series is measured,
"vs_baseline_note"), plus "device", and "gpu" and "power_limit" as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
them (null on the CPU).

vs_baseline: the stacked pairs/s over BASELINE_MEASURED_H100.json's
pairs_per_s, the reference's per-pair CPU loop (matching + GNC-TLS only)
that scripts/measure_baseline.py measures, run on the host of the H100
machine. Without that file vs_baseline is null and vs_baseline_note says
why.

    python3 bench_torch.py                 # the card (raises without one)
    python3 bench_torch.py --device cpu    # the kernels' plain versions

Environment, as bench.py's: BENCH_POINTS (1024), BENCH_PAIRS (64),
BENCH_STACK (6), BENCH_KERNEL (dgcnn; pointnet for the sph_pt series),
BENCH_FLAGSHIP (1: also measure sph_pt after a dgcnn series),
BENCH_GNC_EARLY_EXIT (1).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from rift_tpu_torch.data import SyntheticPairs
from rift_tpu_torch.device import nvidia_smi, resolve_device
from rift_tpu_torch.models import bench_model
from rift_tpu_torch.registration import register_batch
from rift_tpu_torch.train.steps import init_params

BASELINE_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "BASELINE_MEASURED_H100.json")
POINTS, PAIRS, STACK = 1024, 64, 6  # bench.py's defaults of BENCH_POINTS, _PAIRS, _STACK
REPS = 3  # timed stacks after the warm-up


def _baseline_pairs_per_s() -> float | None:
    """BASELINE_FILE's pairs_per_s, or None when there is no such file."""
    try:
        with open(BASELINE_FILE) as f:
            return float(json.load(f)["pairs_per_s"])
    except FileNotFoundError:
        return None


def _make_model(kernel: str, device: torch.device) -> torch.nn.Module:
    """bench.py's model for a point kernel ('dgcnn' or 'pointnet'), bf16,
    seeded from 0, in eval mode on `device`."""
    model = bench_model(kernel)
    init_params(model, 0)
    return model.to(device).eval()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _register_stack(model, src_stack, dst_stack, early_exit: bool) -> torch.Tensor:
    """register_batch on each batch of the stack [stack, b, n, 3], enqueued
    back to back: transforms [stack, b, 4, 4]."""
    return torch.stack([register_batch(model, s, d, device=s.device, early_exit=early_exit)
                        for s, d in zip(src_stack, dst_stack)])


def _measure(kernel: str, src, dst, batch_pairs: int, stack: int,
             device: str | torch.device | None = None) -> tuple[float, torch.Tensor]:
    """Sustained pairs/s of the register pass for one model kernel, `stack`
    batches enqueued back to back per stack (stack=1: one batch at a time),
    and the last timed stack's transforms [stack, b, 4, 4]: the stack's
    sources plus (REPS - 1)·1e-4 against its targets. `device=None` is the
    card, and raises when there is none."""
    device = resolve_device(device)
    early_exit = os.environ.get("BENCH_GNC_EARLY_EXIT", "1") != "0"
    model = _make_model(kernel, device)
    src = torch.as_tensor(src, dtype=torch.float32, device=device)
    dst = torch.as_tensor(dst, dtype=torch.float32, device=device)
    src_stack = torch.stack([src + 1e-4 * i for i in range(stack)])
    dst_stack = torch.stack([dst] * stack)

    _register_stack(model, src_stack, dst_stack, early_exit)  # warm-up: build, cuDNN's choice
    _sync(device)
    t0 = time.perf_counter()
    outs = [_register_stack(model, src_stack + 1e-4 * i, dst_stack, early_exit)
            for i in range(REPS)]
    _sync(device)
    dt = (time.perf_counter() - t0) / REPS
    return batch_pairs * stack / dt, outs[-1]


def result_line(stacked: float, one_batch: float, flagship: float | None, n_points: int,
                batch_pairs: int, stack: int, series_kernel: str, kernel_set: bool,
                device: torch.device) -> dict:
    """bench.py's JSON line for these rates (pairs/s), with the device and,
    on the card, its name and power limit. `kernel_set`: BENCH_KERNEL was
    given."""
    baseline = _baseline_pairs_per_s()
    card = nvidia_smi() if device.type == "cuda" else None
    gpu, _, power_limit = card.partition(", ") if card else (None, None, None)
    out = {
        "metric": f"registered scan-pairs/s/card ({n_points}-pt, feat+match+GNC)",
        "value": round(stacked, 3),
        "unit": "pairs/s",
        "vs_baseline": None if baseline is None else round(stacked / baseline, 3),
        "kernel": f"sph_{'dg' if series_kernel == 'dgcnn' else 'pt'}",
        "stack": stack,
        "stacked_pairs_per_s": round(stacked, 3),
        "one_batch_pairs_per_s": round(one_batch, 3),
    }
    if flagship is not None:
        out["flagship_kernel"] = "sph_pt"
        out["flagship_stacked_pairs_per_s"] = round(flagship, 3)
    notes = []
    if baseline is None:
        notes.append(f"no {os.path.basename(BASELINE_FILE)}: scripts/measure_baseline.py "
                     "run on the card's host gives the denominator")
    if (n_points, batch_pairs) != (POINTS, PAIRS) or kernel_set:
        notes.append("baseline measured at the default dgcnn/1024pt/64pair config")
    if notes:
        out["vs_baseline_note"] = "; ".join(notes)
    out.update(device=device.type, gpu=gpu, power_limit=power_limit or None)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="registered scan-pairs/s, bench.py's twin")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="the CUDA card (default; raises without one) or the CPU's plain "
                         "versions of the kernels")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    n_points = int(os.environ.get("BENCH_POINTS", POINTS))
    batch_pairs = int(os.environ.get("BENCH_PAIRS", PAIRS))
    stack = int(os.environ.get("BENCH_STACK", STACK))  # batches per stack
    series_kernel = os.environ.get("BENCH_KERNEL", "dgcnn")

    src, dst, _ = SyntheticPairs(num_pairs=batch_pairs, num_points=n_points, mode="noise",
                                 max_amp=0.5).arrays()
    stacked, _ = _measure(series_kernel, src, dst, batch_pairs, stack, device)
    one_batch, _ = _measure(series_kernel, src, dst, batch_pairs, 1, device)
    flagship = None
    if os.environ.get("BENCH_FLAGSHIP", "1") != "0" and series_kernel == "dgcnn":
        flagship, _ = _measure("pointnet", src, dst, batch_pairs, stack, device)
    print(json.dumps(result_line(stacked, one_batch, flagship, n_points, batch_pairs, stack,
                                 series_kernel, "BENCH_KERNEL" in os.environ, device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
