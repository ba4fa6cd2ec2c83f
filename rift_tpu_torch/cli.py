"""Command line of rift_tpu_torch, the twin of `rift_tpu/cli.py`:

  python -m rift_tpu_torch.cli presets
  python -m rift_tpu_torch.cli train --preset mn40_sph_dg [--no-resume] [a.b=v ...]
  torchrun --nproc_per_node=4 -m rift_tpu_torch.cli train --preset mn40_sph_dg [...]
  python -m rift_tpu_torch.cli evaluate --preset reg_icl_nuim [--ckpt DIR] \
      [--best METRIC] [--untrained] [--methods ransac,fgr,...] [a.b=v ...]
  python -m rift_tpu_torch.cli map-sequence --preset reg_icl_nuim_teaserpp_cu_dg \
      [--ckpt DIR] [--best METRIC] [--loop-stride S] [--landmarks-per-edge L] \
      [--mesh] [a.b=v ...]
  torchrun --nproc_per_node=4 -m rift_tpu_torch.cli map-sequence --mesh [...]
  python -m rift_tpu_torch.cli evaluate-cls --preset mn40_sph_dg [--ckpt DIR] \
      [--best METRIC] [--rotations K] [--no-hard] [--sweep] [dataset.a=v ...]
  python -m rift_tpu_torch.cli train-seg --preset shapenet_seg [a.b=v ...]

Every command but `presets` runs on the CUDA card (`--device cuda`, the
default, which fails without one) or, when asked, on the CPU with the
kernels' plain versions (`--device cpu`). `a.b=v` overrides set preset
fields (`train/config.py:apply_overrides`). Under torchrun, `train` and
`train-seg` join the process group of their environment (NCCL between
cards, gloo with `--device cpu`) and train data-parallel
(`train.data_parallel`), and `map-sequence --mesh` joins it to shard its
pose-graph and bundle-adjustment solves (every rank runs the rest; rank
0 prints); without a launcher, `--mesh` runs them on a group of one rank.
`train-seg` resumes from `common` in `train.ckpt_dir`, as the
reference's does, and trains on the synthetic ShapeNet split (the
reference's command line passes no data directory). `evaluate --methods`
runs every listed method on one matching pass and prints
`{method}_{metric}` lines ('+' written '_').
"""
from __future__ import annotations

import argparse
import os
import sys

import torch.distributed as dist

from .parallel import initialize_multihost, rank_and_world
from .train import (apply_overrides, evaluate_classification_ckpt, evaluate_registration,
                    evaluate_registration_sweep, get_config, presets, run_map_sequence,
                    train_segmentation)
from .train import train as run_train
from .train.checkpoint import checkpoint_exists


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
                        help="comma list: every method on ONE matching pass; prints "
                             "{method}_{metric} lines")
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
                           help="multi-scan mapping: pairwise registration -> odometry -> "
                                "pose graph -> bundle adjustment -> ATE")
    p_map.add_argument("--preset", default="reg_icl_nuim_teaserpp_cu_dg")
    p_map.add_argument("--ckpt", default=None, metavar="DIR")
    p_map.add_argument("--best", default=None, metavar="METRIC")
    p_map.add_argument("--loop-stride", type=int, default=6)
    p_map.add_argument("--landmarks-per-edge", type=int, default=64)
    p_map.add_argument("--mesh", action="store_true",
                       help="shard the pose-graph and BA solves over the process group")
    p_map.add_argument("overrides", nargs="*")

    sub.add_parser("presets", help="list experiment presets")
    return parser


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command == "presets":
        for name in sorted(presets()):
            print(name)
        return 0

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
    if args.command == "map-sequence":
        joined = (args.mesh and not dist.is_initialized()
                  and initialize_multihost(args.device) is not None)
        try:
            results = run_map_sequence(config, ckpt_dir=args.ckpt, ckpt_name=ckpt_name,
                                       loop_stride=args.loop_stride,
                                       landmarks_per_edge=args.landmarks_per_edge,
                                       use_mesh=args.mesh, device=args.device)
            if rank_and_world()[0] == 0:
                for key, value in results.items():
                    print(f"{key}: {value:.6f}")
        finally:
            if joined:
                dist.destroy_process_group()
        return 0
    if args.command == "evaluate-cls":
        results = evaluate_classification_ckpt(
            config, ckpt_dir=args.ckpt, ckpt_name=ckpt_name, rotations=args.rotations,
            hard_tier=not args.no_hard, cli_overrides=args.overrides,
            corruption_sweep=args.sweep, device=args.device)
        for key, value in results.items():
            print(f"{key}: {value:.6f}")
        return 0
    if args.ckpt is None and not args.untrained:
        # Fail loudly rather than score random weights. A port checkpoint
        # (<name>.pt) or the reference's orbax directory (<name>/) will do.
        name = ckpt_name or config.evaluate.ckpt_name
        probe = os.path.join(config.train.ckpt_dir, name)
        if not (config.evaluate.ckpt_dir or checkpoint_exists(config.train.ckpt_dir, name)):
            parser.error(f"no checkpoint at {probe + '.pt'!r} or {probe + '/'!r}; pass --ckpt "
                         "DIR / --best METRIC, or --untrained to score random weights")
    if args.methods:
        sweep = evaluate_registration_sweep(config, args.methods.split(","), ckpt_dir=args.ckpt,
                                            ckpt_name=ckpt_name, device=args.device)
        for method, results in sweep.items():
            slug = method.replace("+", "_")
            for key, value in results.items():
                print(f"{slug}_{key}: {value:.6f}")
        return 0
    results = evaluate_registration(config, ckpt_dir=args.ckpt, ckpt_name=ckpt_name,
                                    device=args.device)
    for key, value in results.items():
        print(f"{key}: {value:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
