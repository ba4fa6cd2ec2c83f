#!/usr/bin/env python
"""Post-training validation battery for the flagship checkpoint on the
port, the twin of scripts/validate_flagship.py over `rift_tpu_torch.cli`.

Runs, against a trained checkpoint (the committed flagship is
checkpoints/mn40_sph_pt_r4, `--name best_acc`):
  1. classification test accuracy under random SO(3) (standard + hard
     tier) + rotation consistency (`evaluate-cls --rotations 4`);
  2. registration RRE/RTE/RMSE on the clean / noise / partial /
     partial0.7/0.5/0.3 pairs and the ICL-NUIM-analog adjacent-scan set,
     for each robust estimator including the '+picp'/'+pl' dense
     refinements (`evaluate --methods`, one matching pass a mode), and a
     one-pair-per-batch latency probe;
  3. the multi-scan mapping pipeline (odometry -> pose graph -> BA -> ATE,
     `map-sequence`).

Each step is the reference's step with the same arguments, run as
`python -m rift_tpu_torch.cli <command> [--device D] ...` in a fresh
subprocess under a timeout; a failed step is retried once, and every
failed attempt is printed and recorded. Results append to
VALIDATION_torch_r{N}.jsonl and a summary with the reference's table
layout is rewritten at VALIDATION_torch_r{N}.md, headed by the card's
name and power limit. The exit code is 1 when any step failed.

Usage:
  python3 scripts/validate_flagship_torch.py --ckpt checkpoints/mn40_sph_pt_r4 \
      --name best_acc [--round 1] [--timeout 1800] [--steps cls,reg,map] \
      [--device cuda|cpu] [--modes ...] [--methods ...] [--data-root DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Run as a script, scripts/ heads the path, and its profile.py would shadow
# the standard library's (which torch's compiler imports): the repository
# replaces it.
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path.pop(0)
sys.path.insert(0, REPO)

# The reference's modes and methods (scripts/validate_flagship.py): the
# partialK tiers crop both clouds to quantile bands along a common world
# direction so that K is the source-overlap fraction
# (data/synthetic_pairs.py).
REG_MODES = ("clean", "noise", "partial", "partial0.7", "partial0.5",
             "partial0.3", "icl_nuim")
REG_METHODS = ("teaserpp", "ransac", "fgr", "teaserpp+picp", "ransac+picp",
               "ransac+pl")


def run_step(tag: str, argv: list[str], timeout: float, retries: int = 1,
             on_failure=None) -> dict:
    """`argv` in a subprocess from the repository's root, up to
    `retries` + 1 times: its `key: value` lines as metrics on the first
    attempt that exits 0. Each failed attempt is printed and passed to
    `on_failure` as a record."""
    for attempt in range(retries + 1):
        t0 = time.time()
        try:
            proc = subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                                  timeout=timeout)
        except subprocess.TimeoutExpired:
            error, tail = f"timeout after {timeout:.0f}s", ""
        else:
            if proc.returncode == 0:
                metrics = {}
                for line in proc.stdout.splitlines():
                    m = re.match(r"^([a-z_0-9]+):\s*(-?[0-9.]+(?:e-?\d+)?)$", line)
                    if m:
                        metrics[m.group(1)] = float(m.group(2))
                return {"tag": tag, "ok": True, "metrics": metrics,
                        "sec": round(time.time() - t0, 1)}
            error, tail = f"rc={proc.returncode}", (proc.stdout + proc.stderr)[-2000:]
        print(f"[{tag}] {error} (attempt {attempt})\n{tail}", flush=True)
        if on_failure is not None:
            on_failure({"tag": tag, "ok": False, "metrics": {}, "attempt": attempt,
                        "error": error, "tail": tail, "sec": round(time.time() - t0, 1)})
    return {"tag": tag, "ok": False, "metrics": {}, "sec": round(time.time() - t0, 1)}


def card_line(device: str | None) -> str:
    """The card's name and power limit as nvidia-smi gives them, or what
    ran in their place."""
    if device == "cpu":
        return "the CPU (the kernels' plain PyTorch versions)"
    from rift_tpu_torch.device import nvidia_smi

    return nvidia_smi() or "a CUDA card nvidia-smi did not name"


def step_args(steps, modes, methods, ckpt_args: list[str], mn40_root: str | None = None,
              h5_paths: dict | None = None) -> list[tuple[str, list[str]]]:
    """The battery's steps, (tag, the command line's arguments: the
    command, then its options), as the reference runs them."""
    h5_paths = h5_paths or {}
    out = []
    if "cls" in steps:
        cls_data = ([f"dataset.root='{mn40_root}'"] if mn40_root else
                    ["dataset.synthetic_items="
                     "{'train':2048,'valid':512,'test':512}"])
        out.append(("cls", ["evaluate-cls", "--preset", "mn40_sph_dg", *ckpt_args,
                            "--rotations", "4", *cls_data]))
    if "reg" in steps:
        for mode in modes:
            # One step a mode: every method on one matching pass
            # (evaluate_registration_sweep), 25 pairs a batch as in the
            # reference's battery, so the rows stand beside its rows.
            data = ([f"evaluate.pairs_path='{h5_paths[mode]}'"]
                    if mode in h5_paths else [])
            # The overlap tiers are the partial preset with the mode set.
            preset_mode = "partial" if mode.startswith("partial0") else mode
            if mode.startswith("partial0"):
                data += [f"evaluate.pairs_mode='{mode}'"]
            out.append((f"reg_{mode}", ["evaluate", "--preset",
                                        f"reg_{preset_mode}_teaserpp_cu_dg", *ckpt_args,
                                        "--methods", ",".join(methods),
                                        "evaluate.batch_pairs=25", *data]))
        # One pair a batch: the per-pair latency the reference's reg_time
        # measures (one pair per iteration), beside the batched rows.
        out.append(("reg_latency", ["evaluate", "--preset", "reg_noise_teaserpp_cu_dg",
                                    *ckpt_args, "--methods", "ransac+picp",
                                    "evaluate.batch_pairs=1", "evaluate.num_pairs=8"]))
    if "map" in steps:
        out.append(("map", ["map-sequence", "--preset", "reg_icl_nuim_teaserpp_cu_dg",
                            *ckpt_args, "evaluate.method=ransac+picp"]))
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--name", default=None,
                    help="checkpoint name inside --ckpt (common/best_acc)")
    ap.add_argument("--round", type=int, default=1)
    ap.add_argument("--timeout", type=float, default=1800.0)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="passed to every step (the CLI's default: the card)")
    ap.add_argument("--steps", default="cls,reg,map")
    ap.add_argument("--modes", default=",".join(REG_MODES))
    ap.add_argument("--methods", default=",".join(REG_METHODS))
    ap.add_argument("--data-root", default=None, metavar="DIR",
                    help="real-data root: DIR/modelnet40_normal_resampled for the cls "
                         "step and the DeepGMR h5 test files (modelnet_clean.h5, "
                         "modelnet_noisy.h5, icl_nuim_test.h5, in DIR or DIR/test) for "
                         "the reg modes; only files that exist are passed, the rest "
                         "stay synthetic, as the summary says")
    args = ap.parse_args(argv)
    steps = args.steps.split(",")
    modes = args.modes.split(",")
    methods = args.methods.split(",")
    jsonl = os.path.join(REPO, f"VALIDATION_torch_r{args.round:02d}.jsonl")
    py = sys.executable
    dev = ["--device", args.device] if args.device else []
    ckpt_args = ["--ckpt", args.ckpt]
    if args.name and args.name.startswith("best_"):
        ckpt_args += ["--best", args.name.removeprefix("best_")]
    results: list[dict] = []

    def append(res):
        with open(jsonl, "a") as f:
            f.write(json.dumps(res) + "\n")

    def record(res):
        results.append(res)
        append(res)
        print(f"[{res['tag']}] ok={res['ok']} {res['metrics']} ({res['sec']}s)", flush=True)

    h5_by_mode = {"clean": "modelnet_clean.h5", "noise": "modelnet_noisy.h5",
                  "icl_nuim": "icl_nuim_test.h5"}
    mn40_root, h5_paths = None, {}
    if args.data_root:
        probe = os.path.join(args.data_root, "modelnet40_normal_resampled")
        if os.path.isdir(probe):
            mn40_root = probe
        for mode, fname in h5_by_mode.items():
            for sub in ("", "test"):
                cand = os.path.join(args.data_root, sub, fname)
                if os.path.isfile(cand):
                    h5_paths[mode] = cand
                    break
        print(f"real data: mn40={'yes' if mn40_root else 'SYNTHETIC'} "
              f"h5={sorted(h5_paths) or 'SYNTHETIC'}", flush=True)

    for tag, (command, *rest) in step_args(steps, modes, methods, ckpt_args, mn40_root,
                                           h5_paths):
        record(run_step(tag, [py, "-m", "rift_tpu_torch.cli", command, *dev, *rest],
                        args.timeout, on_failure=append))

    # The summary from the accumulated jsonl (the latest result per tag;
    # failed attempts never hide a result), so a partial re-run refreshes
    # its rows without dropping the others.
    merged: dict[str, dict] = {}
    with open(jsonl) as f:
        for line in f:
            r = json.loads(line)
            if r["ok"] or r["tag"] not in merged:
                merged[r["tag"]] = r
    all_modes = [m for m in REG_MODES if f"reg_{m}" in merged]
    all_modes += [m for m in modes if m not in all_modes]
    slugs_seen = {key[:-4] for r in merged.values() for key in r["metrics"]
                  if key.endswith("_rre")}
    all_methods = list(dict.fromkeys(m for m in list(REG_METHODS) + methods
                                     if m.replace("+", "_") in slugs_seen))
    write_summary(list(merged.values()), args.ckpt, args.round, all_modes, all_methods,
                  card=card_line(args.device), synthetic=not (mn40_root or h5_paths))
    return 0 if all(r["ok"] for r in results) else 1


def write_summary(results: list[dict], ckpt: str, rnd: int, modes=REG_MODES,
                  methods=REG_METHODS, card: str = "", synthetic: bool = True) -> str:
    """VALIDATION_torch_r{rnd}.md: the reference's sections and table rows
    for these results, headed by the card. Returns its path."""
    path = os.path.join(REPO, f"VALIDATION_torch_r{rnd:02d}.md")
    by = {r["tag"]: r for r in results}
    lines = [
        f"# VALIDATION (rift_tpu_torch) — round {rnd} flagship checkpoint",
        "",
        f"Device: {card}.",
        "",
        f"Checkpoint: `{ckpt}`. "
        + ("Pairs, sequences and classification items are the synthetic sets "
           "(the procedural shapes and the indoor-sequence analog), as in the "
           "reference's battery." if synthetic else
           "Real-data files were passed where they exist (see the run's log)."),
        "",
    ]
    cls = by.get("cls")
    if cls:
        m = cls["metrics"]
        lines += [
            "## Classification (random SO(3) test split)",
            "",
            f"- accuracy (standard tier): **{m.get('acc', float('nan')):.4f}** "
            "(reference sph-dg on real MN40: 0.897, README.md:34)",
            f"- accuracy (hard tier, train/loop.py:hard_tier_dataset): "
            f"**{m.get('acc_hard', float('nan')):.4f}**",
            f"- rotation agreement (4 random SO(3) copies): "
            f"{m.get('rot_agree', float('nan')):.4f}",
            f"- logit drift across rotations: {m.get('logit_drift', float('nan')):.4f}",
            "",
        ]
    lat = by.get("reg_latency")
    lat_note = ""
    if lat and lat["metrics"]:
        lm = lat["metrics"]
        lat_note = (f"Single-pair latency (batch_pairs=1, ransac+picp, noise mode): "
                    f"**{lm.get('ransac_picp_reg_time', float('nan')):.4f} s/pair**, "
                    "one pair a batch as the reference's `reg_time` measures it. ")
    lines += ["## Registration (100 pairs each, trained trunk, flip-consensus matching)", "",
              "reg_time below is batched seconds/pair (batch_pairs=25, the batch's "
              "wall time over its pairs). " + lat_note,
              "",
              "| set | method | RRE (deg) | RTE | RMSE | success | "
              "reg_time (batched s/pair) |",
              "|---|---|---|---|---|---|---|"]
    for mode in modes:
        r = by.get(f"reg_{mode}")
        if not r:
            continue
        m = r["metrics"]
        for method in methods:
            slug = method.replace("+", "_")
            if not r["ok"] and f"{slug}_rre" not in m:
                lines.append(f"| {mode} | {method} | FAILED | | | | |")
                continue
            lines.append(
                f"| {mode} | {method} "
                f"| {m.get(f'{slug}_rre', float('nan')):.3f} "
                f"| {m.get(f'{slug}_rte', float('nan')):.4f} "
                f"| {m.get(f'{slug}_rmse', float('nan')):.4f} "
                f"| {m.get(f'{slug}_succ', float('nan')):.2f} "
                f"| {m.get(f'{slug}_reg_time', float('nan')):.4f} |")
    lines.append("")
    mp = by.get("map")
    if mp:
        m = mp["metrics"]
        lines += [
            "## Multi-scan mapping (ransac+picp edges, joint BA)",
            "",
            "| stage | ATE |",
            "|---|---|",
            f"| odometry | {m.get('ate_odometry', float('nan')):.4f} |",
            f"| pose graph | {m.get('ate_graph', float('nan')):.4f} |",
            f"| bundle adjust | {m.get('ate_ba', float('nan')):.4f} |",
            "",
            f"mean edge inliers: {m.get('mean_edge_inliers', float('nan')):.3f}"
            f" · mean edge RRE: {m.get('mean_edge_rre', float('nan')):.3f} deg"
            f" · step RRE (odom/graph/BA): "
            f"{m.get('step_rre_odom', float('nan')):.3f} / "
            f"{m.get('step_rre_graph', float('nan')):.3f} / "
            f"{m.get('mean_step_rre', float('nan')):.3f} deg",
            "",
        ]
    with open(path, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {path}", flush=True)
    return path


if __name__ == "__main__":
    sys.exit(main())
