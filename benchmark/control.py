"""Readings that set a cell's limits: the program's numbers on many seeds, the
control's, and planted faults'. Not run by the benchmark's own runs.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --programs port,control,half_batch --calls 4

For each seed and each program the cell is built as a run builds it
(`harness.resolve`, the cell's driver), driven through `--calls` calls,
released and checked; one JSON line a reading:
{"seed", "program", "checks": {name: value}, "correct"}. Programs:

- `port`: the program, as the benchmark runs it (the lower readings);
- `control`: the reference in the program's place, one step below the
  configuration's precision (`lower_precision` of the configuration file:
  fp8 for bf16, TF32 for f32 with TF32 off);
- a fault of `FAULTS`: the program with that fault planted (`planted`,
  which the CPU tests use too).

One process reads every seed, so that the set-up is paid once a program.
It runs on one card; a cell on several cards is read by its one-card
counterpart of the same configuration.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


FAULTS = ("answer_altered", "half_batch", "targets_altered", "unchanged", "exchange_left_out")


@contextlib.contextmanager
def planted(fault: str, targets: int | None = None):
    """The program broken by `fault` while the context lasts; each cell is
    hit by the faults it can have:

    - `answer_altered` (registration): the pose solve's transforms moved by
      0.05 where they are produced;
    - `half_batch`: registration leaves the later half of the pairs
      unsolved (identity); training takes the step on half of each batch,
      its mean over that half;
    - `targets_altered` (registration): the forward's features of the last
      `targets` clouds, the targets, shifted by one along their last axis,
      as a tile or grid index fault on the later clouds of a batch would;
    - `unchanged` (training): the update skipped, the state left as it was;
    - `exchange_left_out` (training on several ranks): the gradients not
      all-reduced.
    """
    import torch
    from rift_tpu_torch.models.pvcnn import PVCNNClassifier
    from rift_tpu_torch.parallel import sharded_ops
    from rift_tpu_torch.registration import pipeline
    from rift_tpu_torch.train import steps

    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    saved = [(pipeline, "gnc_pose"), (pipeline, "teaser_pose"), (steps, "train_step"),
             (steps, "apply_update"), (sharded_ops, "average_gradients"),
             (PVCNNClassifier, "forward")]
    saved = [(owner, name, getattr(owner, name)) for owner, name in saved]

    def solver(original, alter):
        def broken(*args, **kwargs):
            transform, rest = original(*args, **kwargs)
            return alter(transform.clone()), rest
        return broken

    if fault == "answer_altered":
        def moved(t):
            t[:, :3, 3] += 0.05
            return t
        pipeline.gnc_pose = solver(pipeline.gnc_pose, moved)
        pipeline.teaser_pose = solver(pipeline.teaser_pose, moved)
    elif fault == "half_batch":
        def unsolved(t):
            t[t.shape[0] // 2:] = torch.eye(4, dtype=t.dtype, device=t.device)
            return t
        pipeline.gnc_pose = solver(pipeline.gnc_pose, unsolved)
        pipeline.teaser_pose = solver(pipeline.teaser_pose, unsolved)
        train_step = steps.train_step

        def half(state, clouds, labels, generator=None):
            n = clouds.shape[0] // 2
            return train_step(state, clouds[:n], labels[:n], generator)
        steps.train_step = half
    elif fault == "targets_altered":
        if not targets:
            raise ValueError("targets_altered needs the number of target clouds")
        forward = PVCNNClassifier.forward

        def altered(self, *args, **kwargs):
            out = forward(self, *args, **kwargs).clone()
            out[-targets:] = out[-targets:].roll(1, dims=-1)
            return out
        PVCNNClassifier.forward = altered
    elif fault == "unchanged":
        steps.apply_update = lambda state: None
    else:
        sharded_ops.average_gradients = lambda model, group=None: None
    try:
        yield
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)


def reading(spec: harness.CellSpec, seed: int, program: str, calls: int, device) -> dict:
    """Build the cell with `program`, drive `calls` calls, check."""
    import torch

    kind = "control" if program == "control" else "port"
    fault = (contextlib.nullcontext() if program in ("port", "control")
             else planted(program, spec.traffic.get("pairs")))
    with fault:
        cell = harness.load_piece("drivers", spec.traffic["driver"]).build(
            harness.Context(spec, seed, device, program=kind))
        first = getattr(cell, "calls_in_setup", 0)
        for i in range(first, first + calls):
            cell.call(i)
    torch.cuda.synchronize(device)
    cell.release()
    gc.collect()
    torch.cuda.empty_cache()
    checks = cell.check()
    return {"seed": seed, "program": program, "checks": {c.name: c.value for c in checks},
            "correct": all(c.ok for c in checks),
            "diagnostics": getattr(cell, "diagnostics", None)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--programs", default="port,control")
    ap.add_argument("--calls", type=int, default=4)
    args = ap.parse_args(argv)
    os.environ.update(harness.cache_environment())
    import torch

    if not torch.cuda.is_available():
        print("error: the readings are taken on a CUDA card", file=sys.stderr)
        return 3
    spec = harness.resolve(args.workload)
    device = torch.device("cuda", 0)
    for program in args.programs.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            print(json.dumps(reading(spec, seed, program, args.calls, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
