"""Data-parallel training against one process, through the command line.

    python3 scripts/dp_train_check.py [--nproc N] [--preset mn40_sph_dg] [--bf16]
        [--device cuda|cpu]

Runs `torchrun --standalone --nproc_per_node=N -m rift_tpu_torch.cli train`
(one card a rank with NCCL, or N gloo processes with `--device cpu`) and
then the same command as one process, twice, on the preset's model at
full width with its synthetic split cut to ITEMS, EPOCHS epochs of STEPS
steps of BATCH clouds. Each run's metric log gives the epochs' mean train
loss and seconds; the last epoch's seconds (the kernels built, cuDNN's
algorithms chosen) give ms/step and clouds/s. The two one-process runs
differ only where the card's sums are not deterministic (cuDNN's
convolution backward may add in any order), which Adam and the training
amplify from step to step; their largest relative difference over the
epochs is the run-to-run spread. Fails unless the data-parallel run logged
that it ran over N ranks and every epoch's loss of it is within the larger
of LOSS_RTOL and SPREAD_TIMES times that spread of the first one-process
run's. A third one-process run with the augmentation's translation
amplitude nudged from 3.0 to NUDGED_AMP (`dataset.max_amp`; the random
draws stay the same, and the model centres each cloud, so its inputs
move by rounding alone) shows how far the training carries a
rounding-level change; it is reported and not held. `--nproc 1` makes the one-process runs only.
Prints one JSON line; the runs' checkpoints go to a temporary directory.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, STEPS, EPOCHS = 16, 6, 2
ITEMS = {"train": BATCH * STEPS, "valid": 32, "test": 16}
# The same function on the same batches, the global batch's BatchNorm
# statistics combined from the ranks' and the gradients summed over them:
# only the order of the sums differs, and Adam turns a gradient element
# that is rounding into a ±lr step of either sign, so the trajectories part
# slowly over the steps.
LOSS_RTOL = 1e-2
SPREAD_TIMES = 2.0
NUDGED_AMP = 3.000001  # the presets' max_amp is 3.0


def run(cmd: list[str], ckpt_dir: str, device: str) -> tuple[str, list[dict]]:
    env = dict(os.environ, PYTHONPATH=ROOT)
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=1500)
    if out.returncode != 0:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-8000:])
        sys.exit(f"{' '.join(cmd[:6])} ... exited {out.returncode}")
    with open(os.path.join(ckpt_dir, f"{cmd[cmd.index('--preset') + 1]}.metrics.jsonl")) as f:
        return out.stderr, [json.loads(line) for line in f]


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--nproc", type=int, default=None,
                        help="ranks (default: every visible card; 4 with --device cpu)")
    parser.add_argument("--preset", default="mn40_sph_dg")
    parser.add_argument("--bf16", action="store_true", help="model.dtype=bfloat16")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA card; pass --device cpu for gloo processes")
    nproc = args.nproc or (torch.cuda.device_count() if args.device == "cuda" else 4)
    if BATCH % nproc:
        sys.exit(f"{nproc} ranks do not divide the batch of {BATCH}")
    card = "cpu"
    if args.device == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()
        print("\n".join(card), flush=True)
    overrides = [f"train.batch_size={BATCH}", f"train.steps_per_epoch={STEPS}",
                 f"optim.num_epochs={EPOCHS}", f"dataset.synthetic_items={ITEMS!r}"]
    if args.bf16:
        overrides.append("model.dtype=bfloat16")
    runs = [("single", [], []), ("single_again", [], []),
            ("single_nudged", [], [f"dataset.max_amp={NUDGED_AMP}"])]
    if nproc > 1:
        runs.insert(0, ("dp", ["-m", "torch.distributed.run", "--standalone",
                               f"--nproc_per_node={nproc}"], []))
    results = {}
    for name, launcher, extra in runs:
        with tempfile.TemporaryDirectory() as ckpt_dir:
            log, metrics = run([sys.executable, *launcher, "-m", "rift_tpu_torch.cli", "train",
                                "--preset", args.preset, "--device", args.device, "--no-resume",
                                f"train.ckpt_dir={ckpt_dir}", *overrides, *extra], ckpt_dir,
                               args.device)
        train = [r for r in metrics if r["split"] == "train"]
        last_s = train[-1]["sec"]
        results[name] = dict(loss=[r["loss"] for r in train], sec=[r["sec"] for r in train],
                             ms_per_step=last_s / STEPS * 1e3,
                             clouds_per_s=BATCH * STEPS / last_s,
                             valid_acc=[r["acc"] for r in metrics if r["split"] == "valid"],
                             data_parallel=f"data-parallel over {nproc} ranks" in log)
    def rel_diff(name: str) -> list[float]:
        return [abs(a - b) / b for a, b in zip(results[name]["loss"], results["single"]["loss"])]

    spread = max(rel_diff("single_again"))
    tol = max(LOSS_RTOL, SPREAD_TIMES * spread)
    rel = rel_diff("dp") if nproc > 1 else []
    ok = nproc == 1 or (results["dp"]["data_parallel"]
                        and not results["single"]["data_parallel"] and max(rel) <= tol)
    print(json.dumps({"ok": ok, "card": card, "ranks": nproc, "preset": args.preset,
                      "bf16": args.bf16, "batch": BATCH, "steps": STEPS, "epochs": EPOCHS,
                      "loss_rel_diff": rel, "run_to_run_spread": spread, "loss_tol": tol,
                      "nudged_max_amp": NUDGED_AMP, "nudge_rel_diff": rel_diff("single_nudged"),
                      **results}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
