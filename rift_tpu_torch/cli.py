"""Command line of rift_tpu_torch, the twin of `rift_tpu/cli.py`:

  python -m rift_tpu_torch.cli presets
  python -m rift_tpu_torch.cli train --preset mn40_sph_dg [--no-resume] [a.b=v ...]
  python -m rift_tpu_torch.cli evaluate --preset reg_icl_nuim [--ckpt DIR] \
      [--best METRIC] [--untrained] [a.b=v ...]

`train` and `evaluate` run on the CUDA card (`--device cuda`, the
default, which fails without one) or, when asked, on the CPU with the
kernels' plain versions (`--device cpu`). `a.b=v` overrides set preset
fields (`train/config.py:apply_overrides`). The reference's method sweep
(`evaluate --methods`), `evaluate-cls`, `map-sequence` and `train-seg`
are not ported yet and exit with the ROADMAP item that ports them.
"""
from __future__ import annotations

import argparse
import os
import sys

from .train import apply_overrides, evaluate_registration, get_config, presets
from .train import train as run_train

# Not ported yet: (subcommand or option, ROADMAP item).
NOT_PORTED = {"--methods": 10, "evaluate-cls": 9, "map-sequence": 10, "train-seg": 9}


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

    for name, preset in (("evaluate-cls", "mn40_sph_dg"),
                         ("map-sequence", "reg_icl_nuim_teaserpp_cu_dg"),
                         ("train-seg", "shapenet_seg")):
        p = sub.add_parser(name, parents=[device],
                           help=f"not ported yet (ROADMAP item {NOT_PORTED[name]})")
        p.add_argument("--preset", default=preset)

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
    if args.command == "train":
        run_train(config, resume=not args.no_resume, device=args.device)
        return 0
    ckpt_name = f"best_{args.best}" if args.best else None
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
