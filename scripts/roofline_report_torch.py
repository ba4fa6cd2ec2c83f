"""Per-stage roofline report of rift_tpu_torch on one CUDA card, at the
shapes of `scripts/roofline_report.py`.

    python3 scripts/roofline_report_torch.py

Runs `chip_smoke.py`'s roofline phase alone: builds the kernels, times
normals, the bf16 bench model's local branch and its two PVConvs, mutual
NN and `gnc_pose` with each schedule (64 pairs of 1024 points), sets each
beside its bound from `rift_tpu_torch/train/roofline.py` at the card's
peaks. Holds K1, K2, K3 and K5 against their plain versions at those
shapes, each stage's launches against the reckoned ones, and the two GNC
schedules bit-equal, timing them (and register_batch on each) on the
16-pair main batch too. Prints the phase's
lines, then its report as JSON with an indent, the card's name and power
limit in it. Exits non-zero without a card, for a card without peaks, or
when a check fails.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this report needs one CUDA card",
              file=sys.stderr, flush=True)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from rift_tpu_torch.data import SyntheticPairs
    from rift_tpu_torch.ops.cuda import build, kernel_wrappers

    build.load()
    dev = torch.device("cuda")
    src, dst, _ = (torch.as_tensor(a, device=dev) for a in SyntheticPairs(
        num_pairs=smoke.NUM_PAIRS, num_points=smoke.NUM_POINTS, mode="noise", seed=0).arrays())
    model = smoke.seeded_model(0).to(dev)
    smi = smoke.nvidia_smi()
    print(smi, flush=True)
    report = smoke.roofline_phase(model, src, dst, kernel_wrappers(), smi)
    print(json.dumps(report, indent=2), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
