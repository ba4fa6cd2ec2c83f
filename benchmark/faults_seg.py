"""Faults of the segmentation cell, planted in the program and read as
`control.py` reads its programs. Not run by the benchmark's own runs.

    python3 benchmark/faults_seg.py --workload shapenet_seg.train_b8_n2048 \
        --seeds 1,2,3 --faults labels_shifted,dropout_skipped --calls 4

For each fault and seed the cell is built, driven, released and checked
with the fault planted (`control.reading` of the program); one JSON line a
reading, `control.py`'s. The faults:

- `labels_shifted`: the step trains on each point's part moved by one
  inside its category's range (the last part to the first), as a label
  table one off would;
- `dropout_skipped`: the head's dropout left out in train mode.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import control, harness, seg_clouds  # noqa: E402

FAULTS = ("labels_shifted", "dropout_skipped")


def shifted_parts() -> list[int]:
    """Each part label's neighbour inside its category's range."""
    out = []
    for offset, parts in zip(seg_clouds.OFFSETS, seg_clouds.PARTS):
        out += [offset + (i + 1) % parts for i in range(parts)]
    return out


@contextlib.contextmanager
def planted(fault: str):
    """The program broken by `fault` while the context lasts."""
    import torch
    from rift_tpu_torch.models import shapenet
    from rift_tpu_torch.train import steps

    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    saved = [(steps, "train_step", steps.train_step),
             (shapenet, "train_dropout", shapenet.train_dropout)]
    if fault == "labels_shifted":
        table = torch.tensor(shifted_parts())
        train_step = steps.train_step

        def shifted(state, clouds, labels, generator=None):
            return train_step(state, clouds, table.to(labels.device)[labels], generator)
        steps.train_step = shifted
    else:
        shapenet.train_dropout = lambda x, rate, generator, group=None: x
    try:
        yield
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--faults", default=",".join(FAULTS))
    ap.add_argument("--calls", type=int, default=4)
    args = ap.parse_args(argv)
    os.environ.update(harness.cache_environment())
    import torch

    if not torch.cuda.is_available():
        print("error: the readings are taken on a CUDA card", file=sys.stderr)
        return 3
    spec = harness.resolve(args.workload)
    device = torch.device("cuda", 0)
    for fault in args.faults.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            with planted(fault):
                out = control.reading(spec, seed, "port", args.calls, device)
            print(json.dumps(dict(out, program=fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
