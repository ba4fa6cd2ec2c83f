"""K1 (normals moments), K2 (voxel scatter-mean), K3 (corner gather) and
K4 (corner scatter) on one CUDA card at the shapes chip_smoke.py times them:
K1 on its 32 registration clouds of 1024 points (k = 16, r² = 0.01) and on
its LARGE_CLOUDS; K2 on those 32 clouds at r = 32 (f32 features of 67 and
64 channels, bf16 of 71 and 64); K3 on grids of 64 and 128 channels, f32
and bf16, with the clouds' int64 corner indices as the path passes them
(and f32 with int32 indices); K4 on the first 16 clouds (64 and 128
channels); the clouds' own spherical voxel and corner indices.

    python3 scatter_ab.py --other DIR   # A/B against another checkout
    python3 scatter_ab.py --tiles       # this checkout, every voxel tile

--other DIR times the kernels of the checkout at DIR (for example the
parent commit unpacked with `git archive` into a git-ignored directory)
and of this one in turns, other, this, this, other, each turn in its own
process that builds its checkout's kernels, through each checkout's
wrappers (so an int32 copy that a wrapper makes of int64 indices is
timed). --tiles calls K2's and K4's C entry points of this checkout with
each voxel tile of `onehot_ops.VOXEL_TILES`, at those shapes and, with 64
channels, on chip_smoke.py's clouds of 2048, 5000 and 16384 points. Times
are chip_smoke.py's: the per-call median of 20 CUDA-event timings (each
call's host enqueue included), the back-to-back time of 20 calls and their
device-only time (`dev_ms`: queued behind a sleep that outlasts their
enqueue). The card's name and power limit come first. Imports only torch
and rift_tpu_torch (no JAX).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
S = 32 ** 3  # voxels at r = 32


def _smoke():
    """chip_smoke.py of this checkout, for its timers and peaks."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _indices(pairs: int, n: int, seed: int, both: bool):
    """(inds [b, n], idx [b, n, 8] int32, w [b, n, 8]) at r = 32 of the
    source clouds of SyntheticPairs(pairs, n, "noise", seed), and of their
    destination clouds after them if `both`, on the card."""
    import torch

    from rift_tpu_torch.data import SyntheticPairs
    from rift_tpu_torch.ops.spherical import (normalize_coords_sphere,
                                              spherical_corner_weights,
                                              spherical_voxel_indices)

    src, dst, _ = SyntheticPairs(num_pairs=pairs, num_points=n, mode="noise",
                                 seed=seed).arrays()
    clouds = torch.cat([torch.as_tensor(a) for a in ((src, dst) if both else (src,))])
    norm = normalize_coords_sphere(clouds.cuda())
    inds, _ = spherical_voxel_indices(norm, 32)
    idx, w = spherical_corner_weights(norm, inds, 32)
    return inds.to(torch.int32), idx.to(torch.int32).contiguous(), w.contiguous()


def _cases(large: bool = False) -> dict:
    """{name: (kernel "K1" to "K4", input, indices, weights or None)}: the
    shapes chip_smoke.py times (its 32 registration clouds at r = 32, the
    first 16 for K4; K1 also on its LARGE_CLOUDS, seed 3 as there); with
    `large`, also K2 and K4 at c = 64 on those large clouds."""
    import torch

    from rift_tpu_torch.data import SyntheticPairs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    src, dst, _ = SyntheticPairs(num_pairs=16, num_points=1024, mode="noise", seed=0).arrays()
    clouds = torch.cat([torch.as_tensor(src), torch.as_tensor(dst)]).to(dev)
    inds, idx, w = _indices(16, 1024, seed=0, both=True)
    idx64 = idx.long()
    cases = {"K1 b=32 n=1024": ("K1", clouds, None, None)}
    for b, n in _smoke().LARGE_CLOUDS:
        cases[f"K1 b={b} n={n}"] = ("K1", torch.as_tensor(SyntheticPairs(
            num_pairs=b, num_points=n, mode="noise", seed=3).arrays()[0], device=dev), None, None)
    cases.update({f"K2 f32 c={c}": ("K2", torch.randn((32, 1024, c), generator=gen, device=dev),
                                    inds, None) for c in (67, 64)})
    cases.update({f"K2 bf16 c={c}": ("K2", torch.randn((32, 1024, c), generator=gen, device=dev)
                                     .to(torch.bfloat16), inds, None) for c in (71, 64)})
    for dtype, label in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for c in (64, 128):
            grid = torch.randn((32, S, c), generator=gen, device=dev).to(dtype)
            cases[f"K3 {label} c={c} int64"] = ("K3", grid, idx64, w)
            if dtype == torch.float32:
                cases[f"K3 {label} c={c} int32"] = ("K3", grid, idx, w)
    cases.update({f"K4 c={c}": ("K4", torch.randn((16, 1024, c), generator=gen, device=dev),
                                idx[:16].contiguous(), w[:16].contiguous()) for c in (64, 128)})
    if large:
        for b, n in _smoke().LARGE_CLOUDS:
            inds, idx, w = _indices(b, n, seed=3, both=False)
            cases[f"K2 b={b} n={n} c=64"] = ("K2", torch.randn((b, n, 64), generator=gen,
                                                                device=dev), inds, None)
            cases[f"K4 b={b} n={n} c=64"] = ("K4", torch.randn((b, n, 64), generator=gen,
                                                                device=dev), idx, w)
    return cases


def _wrapper_call(kind, x, ind, w, s):
    """fn() calling the wrapper of `kind` of the rift_tpu_torch first on
    sys.path."""
    from rift_tpu_torch.ops.cuda import normals_kernel as nk
    from rift_tpu_torch.ops.cuda import onehot_ops as oh

    if kind == "K1":
        return lambda: nk.neighborhood_moments(x, 16, 0.01)
    if kind == "K2":
        return lambda: oh.scatter_mean(x, ind, s)
    if kind == "K3":
        return lambda: oh.corner_gather(x, ind, w)
    return lambda: oh.corner_scatter(x, ind, w, s)


def time_checkout() -> dict:
    """Per-call and back-to-back ms of each case through the wrappers of
    the rift_tpu_torch first on sys.path."""
    import torch

    smoke = _smoke()
    out = {}
    for name, (kind, x, ind, w) in _cases().items():
        fn = _wrapper_call(kind, x, ind, w, S)
        fn()
        torch.cuda.synchronize()
        out[name] = {"ms": smoke.cuda_time_ms(fn), "b2b_ms": smoke.b2b_ms(fn),
                     "dev_ms": smoke.dev_ms(fn)}
    return out


def time_tiles() -> dict:
    """Back-to-back ms of each case, clouds past 1024 points included, for
    each voxel tile, through the C entry points of this checkout, each
    output equal to the wrapper's."""
    import torch

    from rift_tpu_torch.ops.cuda import build
    from rift_tpu_torch.ops.cuda import onehot_ops as oh

    smoke = _smoke()
    lib = build.load()
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name, (kind, x, ind, w) in _cases(large=True).items():
        if kind not in ("K2", "K4"):
            continue
        b, n, c = x.shape
        grid = torch.empty((b, S, c), device=x.device)
        cnt = torch.empty((b, S), device=x.device)
        want = _wrapper_call(kind, x, ind, w, S)()
        want = want[0] if kind == "K2" else want
        row = {}
        for tile in oh.VOXEL_TILES:
            if kind == "K2":
                def fn(tile=tile):
                    build.check(lib.rift_scatter_mean(
                        x.data_ptr(), int(x.dtype == torch.bfloat16), ind.data_ptr(), b, n, c,
                        S, tile, grid.data_ptr(), cnt.data_ptr(), stream), "rift_scatter_mean")
            else:
                def fn(tile=tile):
                    build.check(lib.rift_corner_scatter(
                        x.data_ptr(), ind.data_ptr(), w.data_ptr(), b, n, c, S, tile,
                        grid.data_ptr(), stream), "rift_corner_scatter")
            fn()
            torch.cuda.synchronize()
            if not torch.equal(grid, want):
                raise SystemExit(f"{name}: tile {tile} differs from the wrapper's output")
            row[tile] = smoke.b2b_ms(fn)
        out[name] = {"chosen": oh.voxel_tile(b, S, n if kind == "K2" else 8 * n, c),
                     "b2b_ms": row}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", help="another checkout to time in turns with this one")
    parser.add_argument("--tiles", action="store_true", help="sweep the voxel tile")
    parser.add_argument("--time", metavar="ROOT", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.time:  # one turn: the checkout at ROOT, in this process
        sys.path.insert(0, os.path.abspath(args.time))
        print(json.dumps(time_checkout()), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("FAIL: this script needs a CUDA card", file=sys.stderr, flush=True)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    if args.tiles:
        sys.path.insert(0, HERE)
        for name, row in time_tiles().items():
            print(f"{name}: back-to-back ms by tile "
                  + ", ".join(f"{t}: {ms:.4f}" for t, ms in row["b2b_ms"].items())
                  + f"; voxel_tile chooses {row['chosen']}", flush=True)
        return 0
    if not args.other:
        parser.error("give --other DIR or --tiles")
    other = os.path.abspath(args.other)
    turns = [("other", other), ("this", HERE), ("this", HERE), ("other", other)]
    results = []
    for label, root in turns:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time", root],
                              capture_output=True, text=True, cwd=root)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr, flush=True)
            return 1
        results.append((label, json.loads(proc.stdout.strip().splitlines()[-1])))
        print(f"{label} ({root}): {results[-1][1]}", flush=True)
    for name in results[0][1]:
        cells = [f"{label} {res[name]['ms']:.4f} ({res[name]['b2b_ms']:.4f}) "
                 f"[{res[name]['dev_ms']:.4f}]" for label, res in results]
        print(f"{name}: ms per call (back to back) [device only]: " + ", ".join(cells),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
