"""Where the time of rift_tpu_torch's main path goes on one CUDA card.

    python scripts/profile_torch_path.py

Registers chip_smoke.py's main-path batch (NUM_PAIRS SyntheticPairs(
mode="noise", seed=0) pairs of NUM_POINTS points) at the flagship width
with its seeded weights and prints, as JSON lines:
  - "stages": median wall ms of normals, feature forward, mutual NN and
    GNC-TLS over 5 batches, each stage ended by torch.cuda.synchronize();
  - "profile": one batch under torch.profiler — the device time by kernel
    (top 20), the sum of device time, and the device busy share of the
    batch's wall time.
Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import NUM_PAIRS, NUM_POINTS, seeded_model  # noqa: E402
from rift_tpu_torch.data import SyntheticPairs  # noqa: E402
from rift_tpu_torch.ops.neighbors import mutual_nearest_neighbors  # noqa: E402
from rift_tpu_torch.ops.normals import estimate_normals  # noqa: E402
from rift_tpu_torch.ops.precision import f32_geometry  # noqa: E402
from rift_tpu_torch.registration import gnc_pose, register_batch  # noqa: E402
from rift_tpu_torch.registration.pipeline import NOISE_BOUND  # noqa: E402


def staged_batch(model, src, dst) -> dict:
    times = {}
    b = src.shape[0]
    with torch.no_grad(), f32_geometry():
        t = time.perf_counter()
        clouds = torch.cat([src, dst], 0)
        normals = estimate_normals(clouds)
        torch.cuda.synchronize()
        times["normals"] = time.perf_counter() - t
        t = time.perf_counter()
        feats = model(torch.cat([clouds, normals], -1))
        torch.cuda.synchronize()
        times["features"] = time.perf_counter() - t
        t = time.perf_counter()
        _, idx2, mask = mutual_nearest_neighbors(feats[:b], feats[b:])
        matched = torch.gather(dst, 1, idx2[..., None].expand(-1, -1, 3))
        torch.cuda.synchronize()
        times["match"] = time.perf_counter() - t
        t = time.perf_counter()
        gnc_pose(src, matched, mask, noise_bound=NOISE_BOUND)
        torch.cuda.synchronize()
        times["gnc"] = time.perf_counter() - t
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    src, dst, _ = SyntheticPairs(num_pairs=NUM_PAIRS, num_points=NUM_POINTS,
                                 mode="noise", seed=0).arrays()
    src, dst = torch.as_tensor(src, device=dev), torch.as_tensor(dst, device=dev)
    model = seeded_model(0).to(dev)
    register_batch(model, src, dst)  # warm-up, builds the kernels
    torch.cuda.synchronize()

    runs = [staged_batch(model, src, dst) for _ in range(5)]
    stages = {k: sorted(r[k] for r in runs)[2] * 1e3 for k in runs[0]}
    print(json.dumps({"device": torch.cuda.get_device_name(0), "pairs": NUM_PAIRS,
                      "points": NUM_POINTS, "stages_ms": stages,
                      "total_ms": sum(stages.values())}), flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t = time.perf_counter()
        register_batch(model, src, dst)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = []
    for ev in prof.key_averages():
        # Kernel events only: an aten:: op also reports its kernels' time,
        # so counting both would count the device time twice.
        if "CUDA" not in str(ev.device_type):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3
    print(json.dumps({"profile": {
        "wall_ms": wall * 1e3, "device_ms": device_ms,
        "device_busy_share": device_ms / (wall * 1e3) if wall > 0 else None,
        "top": [{"kernel": k[:120], "ms": us / 1e3, "count": c} for us, k, c in rows[:20]]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
