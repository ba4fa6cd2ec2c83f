"""Registration over several ranks: the weak scaling of registered pairs/s,
and the multi-rank `map-sequence --mesh` against one process.

    python3 scripts/weak_scaling_check.py [--nproc N] [--device cuda|cpu]
        [--preset mn40_sph_pt_r4]

The twin of `scripts/bench_scaling.py`. Two runs, each a `torchrun
--standalone --nproc_per_node=N` launch (one card a rank with NCCL, or N
gloo processes with `--device cpu`):

1. `parallel.registration_weak_scaling` at mesh sizes 1, 2 and 4 (those
   <= N): the preset's model as a feature extractor at its full width,
   seeded weights (`train.steps.init_params`, seed 0), PAIRS pairs of
   POINTS points a rank, `ransac+picp` (256 hypotheses), 3 timed calls
   after a warm-up. It reports pairs/s and the efficiency at each size,
   and whether rank 0's shard got the same transforms at every size
   (information).
2. `-m rift_tpu_torch.cli map-sequence --mesh` on MAP_PRESET (the indoor
   sequence's 24 scans, the cube trunk, teaserpp; seeded weights, no
   checkpoint) with `RIFT_MAP_DUMP` set (rank 0 writes the trajectories),
   then the same command as one process
   (its `--mesh` solves on a group of one rank). The pose-graph and BA
   poses of the N-rank run must be within POSE_TOL (max abs entry) of the
   one-process run's: the solves shard the edges and landmarks over the
   ranks, so their sums run in another order. Each command's seconds and
   its stage seconds (the first rank's log line) are reported.

`--preset tiny_smoke` runs both at tiny sizes (the rehearsal on the CPU:
`--device cpu --nproc 4 --preset tiny_smoke`). Prints one JSON line, with
the card's name and power limit; exits 1 when a check fails.
"""
from __future__ import annotations

import argparse
import ast
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MESH_SIZES = (1, 2, 4)
PAIRS, POINTS, REPS = 16, 1024, 3
MAP_PRESET = "reg_icl_nuim_teaserpp_cu_dg"
# The 4-rank sharded solves against one rank's (tests/test_torch_dp.py holds
# 4 gloo ranks to the same bound).
POSE_TOL = 1e-3
# tiny_smoke's sizes for the rehearsal: (pairs a rank, points), and the map's
# preset and overrides (tests/test_torch_cli.py's TINY_MAP).
TINY_PAIRS, TINY_POINTS = 2, 128
TINY_MAP = ("tiny_smoke", ["model.is_classify=False", "sequence.num_scans=8",
                           "sequence.num_points=128", "sequence.scene_points=4096"])
TIMEOUT_S = 900


def worker(args) -> None:
    """One rank of the weak-scaling launch; rank 0 writes the result."""
    import torch

    from rift_tpu_torch.parallel import initialize_multihost, registration_weak_scaling
    from rift_tpu_torch.train import apply_overrides, build_model, get_config
    from rift_tpu_torch.train.steps import init_params

    if args.device == "cpu":
        torch.set_num_threads(1)
    group = initialize_multihost(args.device)
    try:
        cfg = apply_overrides(get_config(args.preset), ["model.is_classify=False"])
        model = build_model(cfg)
        init_params(model, 0)
        model = model.to(args.device).eval()
        res = registration_weak_scaling(MESH_SIZES, args.pairs, args.points, REPS, model=model,
                                        device=args.device)
        if torch.distributed.is_initialized() and torch.distributed.get_rank() != 0:
            return
        shard0 = [bool(torch.equal(res.transforms[s][:args.pairs], res.transforms[1]))
                  for s in res.mesh_sizes]
        with open(args.out, "w") as f:
            json.dump({**res.as_dict(), "pairs_per_s_raw": res.pairs_per_s,
                       "ms_per_call": [s * args.pairs / t * 1e3
                                       for s, t in zip(res.mesh_sizes, res.pairs_per_s)],
                       "shard0_equal_across_sizes": shard0}, f)
    finally:
        if group is not None:
            torch.distributed.destroy_process_group()


def run(cmd: list[str], device: str, **env_extra) -> tuple[float, str]:
    env = dict(os.environ, PYTHONPATH=ROOT, **env_extra)
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-8000:])
        sys.exit(f"{' '.join(cmd[:8])} ... exited {out.returncode}")
    return seconds, out.stderr


def stage_seconds(log: str):
    """The first 'map-sequence seconds: {...}' of a run's log."""
    for line in log.splitlines():
        if "map-sequence seconds:" in line:
            text = line.split("map-sequence seconds:", 1)[1].strip()
            try:
                return ast.literal_eval(text)
            except (ValueError, SyntaxError):
                return text
    return None


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--nproc", type=int, default=None,
                        help="ranks (default: every visible card; 4 with --device cpu)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--preset", default="mn40_sph_pt_r4",
                        help="the weak-scaling model's preset; tiny_smoke for a rehearsal")
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--out", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--pairs", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--points", type=int, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        worker(args)
        return 0
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA card; pass --device cpu for gloo processes")
    nproc = args.nproc or (torch.cuda.device_count() if args.device == "cuda" else 4)
    tiny = args.preset == "tiny_smoke"
    pairs, points = (TINY_PAIRS, TINY_POINTS) if tiny else (PAIRS, POINTS)
    map_preset, map_overrides = TINY_MAP if tiny else (MAP_PRESET, [])
    card = "cpu"
    if args.device == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()
        print("\n".join(card), flush=True)
        from rift_tpu_torch.ops.cuda import build

        build.load()  # once here, so the ranks find the library built
    launcher = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                f"--nproc_per_node={nproc}"]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "scaling.json")
        scaling_s, _ = run([*launcher, os.path.abspath(__file__), "--worker", "--out", out,
                            "--device", args.device, "--preset", args.preset,
                            "--pairs", str(pairs), "--points", str(points)], args.device)
        with open(out) as f:
            scaling = json.load(f)
        maps = {}
        for name, prefix in (("ranks", launcher), ("one_process", [sys.executable])):
            poses = os.path.join(tmp, f"{name}.npz")
            seconds, log = run([*prefix, "-m", "rift_tpu_torch.cli", "map-sequence", "--mesh",
                                "--preset", map_preset, "--device", args.device,
                                f"train.ckpt_dir={tmp}/none", *map_overrides], args.device,
                               RIFT_MAP_DUMP=poses)
            with np.load(poses) as z:
                maps[name] = dict(seconds=seconds, stages=stage_seconds(log),
                                  poses={k: z[k] for k in ("odom", "graph", "ba")})
    diff = {k: float(np.abs(maps["ranks"]["poses"][k] - maps["one_process"]["poses"][k]).max())
            for k in ("odom", "graph", "ba")}
    ok = diff["graph"] <= POSE_TOL and diff["ba"] <= POSE_TOL
    print(json.dumps({
        "ok": ok, "card": card, "ranks": nproc, "preset": args.preset,
        "weak_scaling": {"pairs_per_rank": pairs, "points": points, "reps": REPS,
                         "method": "ransac+picp", "seconds": scaling_s, **scaling},
        "map_sequence": {"preset": map_preset, "overrides": map_overrides,
                         "scans": int(maps["ranks"]["poses"]["ba"].shape[0]),
                         "ranks_seconds": maps["ranks"]["seconds"],
                         "one_process_seconds": maps["one_process"]["seconds"],
                         "ranks_stages": maps["ranks"]["stages"],
                         "one_process_stages": maps["one_process"]["stages"],
                         "max_abs_pose_diff": diff, "pose_tol": POSE_TOL}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
