#!/usr/bin/env python
"""The multi-scan map at a realistic trajectory length on the port, the
twin of scripts/map_drift.py: T = 96 scans of the synthetic indoor
sequence (two orbits of the room), sparse loop closures (every 12 scans),
and the drift curve ATE(T) of odometry, pose graph and bundle adjustment
at T = 12, 24, 48, 72 and the whole sequence. Writes MAP_DRIFT_torch.json
with the card's name and power limit.

Usage:
  python3 scripts/map_drift_torch.py --ckpt checkpoints/mn40_sph_pt_r4 \
      [--name best_acc] [--scans 96] [--loop-stride 12] [--device cuda|cpu] \
      [--out MAP_DRIFT_torch.json]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Run as a script, scripts/ heads the path, and its profile.py would shadow
# the standard library's (which torch's compiler imports): the repository
# replaces it.
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path.pop(0)
sys.path.insert(0, REPO)

PRESET = "reg_icl_nuim_teaserpp_cu_dg"
LANDMARKS_PER_EDGE = 64


def prefix_ate(gt, est, t: int) -> float:
    """ATE of the first `t` poses of the estimate [T, 4, 4] against the
    ground truth's."""
    import torch

    from rift_tpu_torch.registration.pose_graph import trajectory_ate

    return float(trajectory_ate(torch.as_tensor(gt[:t]), torch.as_tensor(est[:t])))


def drift(ckpt: str, name: str = "best_acc", scans: int = 96, loop_stride: int = 12,
          device=None, config=None) -> dict:
    """The map of `config` (PRESET's by default) with `scans` scans over two
    orbits, from the trunk of checkpoint `name` in `ckpt`, its features
    under the 4 LRF flips, edges by the config's method; returns the
    drift curve with the map's edges, metrics and wall seconds."""
    from rift_tpu_torch.data.sequences import SyntheticSequence
    from rift_tpu_torch.registration.sequence import map_sequence
    from rift_tpu_torch.train import get_config
    from rift_tpu_torch.train.loop import extract_features_flips, get_logger, resolve_extractor

    t0 = time.time()
    config = config or get_config(PRESET)
    # Longer than the 24-scan default map, whose loop-rich graph nearly
    # saturates ATE: closures only every `loop_stride` scans leave drift
    # for the back end to fix.
    config.sequence.num_scans = scans
    config.sequence.orbit_degrees = 720.0  # two loops of the room
    log = get_logger("map_drift")
    seq = SyntheticSequence(config.sequence)
    model = resolve_extractor(config, None, ckpt, name, device, log)
    flip_feats = extract_features_flips(model, seq.scans)
    ev = config.evaluate
    res = map_sequence(
        seq.scans, flip_feats[:, 0], gt_poses=seq.gt_poses, method=ev.method,
        noise_bound=ev.noise_bound, num_hypotheses=ev.num_hypotheses,
        inlier_threshold=ev.inlier_threshold, loop_stride=loop_stride,
        landmarks_per_edge=LANDMARKS_PER_EDGE, seed=config.seed,
        flip_features=flip_feats, device=device)

    curve = [{"T": t,
              "ate_odometry": round(prefix_ate(seq.gt_poses, res.odometry, t), 5),
              "ate_graph": round(prefix_ate(seq.gt_poses, res.graph, t), 5),
              "ate_ba": round(prefix_ate(seq.gt_poses, res.ba, t), 5)}
             for t in (12, 24, 48, 72, scans) if t <= scans]
    return {
        "scans": scans,
        "loop_stride": loop_stride,
        "edges": int(res.edges[0].shape[0]),
        "method": ev.method,
        "metrics": {k: round(float(v), 5) for k, v in res.metrics.items()},
        "drift_curve": curve,
        "ba_vs_graph_final": round(curve[-1]["ate_graph"] - curve[-1]["ate_ba"], 5),
        "wall_s": round(time.time() - t0, 1),
    }


def main(argv: list[str] | None = None) -> int:
    from rift_tpu_torch.device import nvidia_smi, resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--name", default="best_acc")
    ap.add_argument("--scans", type=int, default=96)
    ap.add_argument("--loop-stride", type=int, default=12)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="the CUDA card (default; raises without one) or the CPU's plain "
                         "versions of the kernels")
    ap.add_argument("--out", default=os.path.join(REPO, "MAP_DRIFT_torch.json"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = drift(args.ckpt, args.name, args.scans, args.loop_stride, device)
    card = nvidia_smi() if device.type == "cuda" else None
    gpu, _, power_limit = card.partition(", ") if card else (None, None, None)
    out.update(device=device.type, gpu=gpu, power_limit=power_limit or None)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
