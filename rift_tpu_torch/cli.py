"""Command line of rift_tpu_torch, the twin of `rift_tpu/cli.py`:

  python -m rift_tpu_torch.cli presets
  python -m rift_tpu_torch.cli train --preset mn40_sph_dg [--no-resume] [a.b=v ...]
  torchrun --nproc_per_node=4 -m rift_tpu_torch.cli train --preset mn40_sph_dg [...]
  python -m rift_tpu_torch.cli evaluate --preset reg_icl_nuim [--ckpt DIR] \
      [--best METRIC] [--untrained] [a.b=v ...]
  python -m rift_tpu_torch.cli evaluate-cls --preset mn40_sph_dg [--ckpt DIR] \
      [--best METRIC] [--rotations K] [--no-hard] [--sweep] [dataset.a=v ...]
  python -m rift_tpu_torch.cli train-seg --preset shapenet_seg [a.b=v ...]

`train`, `evaluate`, `evaluate-cls` and `train-seg` run on the CUDA card
(`--device cuda`, the default, which fails without one) or, when asked,
on the CPU with the kernels' plain versions (`--device cpu`). `a.b=v`
overrides set preset fields (`train/config.py:apply_overrides`). Under
torchrun, `train` and `train-seg` join the process group of their
environment (NCCL between cards, gloo with `--device cpu`) and train
data-parallel (`train.data_parallel`). `train-seg` resumes from `common`
in `train.ckpt_dir`, as the reference's does, and trains on the synthetic
ShapeNet split (the reference's command line passes no data directory).
The reference's method sweep (`evaluate --methods`) and `map-sequence`
are not ported yet and exit with the ROADMAP item that ports them.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch.distributed as dist

from .parallel import initialize_multihost
from .train import (apply_overrides, evaluate_classification_ckpt, evaluate_registration,
                    get_config, presets, train_segmentation)
from .train import train as run_train

# Not ported yet: (subcommand or option, ROADMAP item).
NOT_PORTED = {"--methods": 10, "map-sequence": 10}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="rift-torch")
    device = argparse.ArgumentParser(add_help=False)
    device.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="the CUDA card (default; fails without one) or the CPU's "
                             "plain versions of the kernels")
    sub = parser.add_subparsers(dest="command", required=True)

    p_train = sub.add_parser("train", parents=[device], help="classification training")
    p_train.add_argument("--preset", default="mn40_sph_dg")
    p_train.add_argument("--no-resume", action="store_true")
    p_train.add_argument("overrides", nargs="*", help="dot-path overrides a.b=v")

    p_eval = sub.add_parser("evaluate", parents=[device], help="registration evaluation")
    p_eval.add_argument("--preset", default="reg_noise_teaserpp_cu_dg")
    p_eval.add_argument("--ckpt", default=None, metavar="DIR",
                        help="checkpoint directory to evaluate")
    p_eval.add_argument("--best", default=None, metavar="METRIC",
                        help="load best_<METRIC> instead of common")
    p_eval.add_argument("--untrained", action="store_true",
                        help="allow evaluating an untrained model (smoke runs only)")
    p_eval.add_argument("--methods", default=None,
                        help="comma list: the method sweep (not ported yet)")
    p_eval.add_argument("overrides", nargs="*")

    p_ecls = sub.add_parser("evaluate-cls", parents=[device],
                            help="classification accuracy and SO(3) rotation consistency "
                                 "of a trained checkpoint")
    p_ecls.add_argument("--preset", default="mn40_sph_dg")
    p_ecls.add_argument("--ckpt", default=None, metavar="DIR")
    p_ecls.add_argument("--best", default=None, metavar="METRIC")
    p_ecls.add_argument("--rotations", type=int, default=4,
                        help="rotated copies per cloud for the consistency meter (0: none)")
    p_ecls.add_argument("--no-hard", action="store_true", help="skip the hard tier")
    p_ecls.add_argument("--sweep", action="store_true",
                        help="accuracy at each corruption level and its mean")
    p_ecls.add_argument("overrides", nargs="*")

    p_seg = sub.add_parser("train-seg", parents=[device], help="ShapeNet part segmentation")
    p_seg.add_argument("--preset", default="shapenet_seg")
    p_seg.add_argument("overrides", nargs="*")

    p_map = sub.add_parser("map-sequence", parents=[device],
                           help=f"not ported yet (ROADMAP item {NOT_PORTED['map-sequence']})")
    p_map.add_argument("--preset", default="reg_icl_nuim_teaserpp_cu_dg")

    sub.add_parser("presets", help="list experiment presets")
    return parser


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args, unknown = parser.parse_known_args(argv)  # the unported commands' own options
    if args.command in NOT_PORTED:
        parser.error(f"{args.command} is not ported yet "
                     f"(ROADMAP item {NOT_PORTED[args.command]})")
    if unknown:
        parser.error(f"unrecognized arguments: {' '.join(unknown)}")
    if args.command == "presets":
        for name in sorted(presets()):
            print(name)
        return 0
    if args.command == "evaluate" and args.methods:
        parser.error(f"evaluate --methods (the method sweep) is not ported yet "
                     f"(ROADMAP item {NOT_PORTED['--methods']})")

    config = get_config(args.preset)
    apply_overrides(config, args.overrides)
    if args.command in ("train", "train-seg"):
        joined = not dist.is_initialized() and initialize_multihost(args.device) is not None
        try:
            if args.command == "train":
                run_train(config, resume=not args.no_resume, device=args.device)
            else:
                train_segmentation(config, device=args.device)
        finally:
            if joined:
                dist.destroy_process_group()
        return 0
    ckpt_name = f"best_{args.best}" if args.best else None
    if args.command == "evaluate-cls":
        results = evaluate_classification_ckpt(
            config, ckpt_dir=args.ckpt, ckpt_name=ckpt_name, rotations=args.rotations,
            hard_tier=not args.no_hard, cli_overrides=args.overrides,
            corruption_sweep=args.sweep, device=args.device)
        for key, value in results.items():
            print(f"{key}: {value:.6f}")
        return 0
    if args.ckpt is None and not args.untrained:
        # Fail loudly rather than score random weights.
        probe = os.path.join(config.train.ckpt_dir,
                             (ckpt_name or config.evaluate.ckpt_name) + ".pt")
        if not (config.evaluate.ckpt_dir or os.path.isfile(probe)):
            parser.error(f"no checkpoint at {probe!r}; pass --ckpt DIR / --best METRIC, "
                         "or --untrained to score random weights")
    results = evaluate_registration(config, ckpt_dir=args.ckpt, ckpt_name=ckpt_name,
                                    device=args.device)
    for key, value in results.items():
        print(f"{key}: {value:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
