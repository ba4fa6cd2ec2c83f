"""Smoke run of rift_tpu_torch on one CUDA card: build the kernels, hold each
against its plain PyTorch version, register 16 scan pairs of 1024 points at
the flagship width, and compare with the CPU run of the same path.

    python3 chip_smoke.py

Phases (each prints one line with its wall time):
  1. device  — nvidia-smi's name and power limit, torch's device name;
               exits non-zero when CUDA is not available.
  2. build   — nvcc builds rift_tpu_torch/csrc/*.cu for sm_90a.
  3. kernels — K1, K2, K3 against their plain versions at the main path's
               shapes, with times, bounds and the library yardsticks.
  4. main    — register_batch on 16 SyntheticPairs(mode="noise", seed=0)
               pairs, flagship width (mn40_sph_pt_r4), seeded random weights;
               one warm-up and 3 timed batches; every launch counter must rise.
  5. parity  — the first 8 pairs of the timed batch against the same path
               with device="cpu"; GNC-TLS and Kabsch on the card against
               the CPU on the CPU run's matches.
Then one JSON line of per-kernel numbers, and the result line
{"ok": true, "device": {...}} last. Any failure exits non-zero before it.

Imports only torch, numpy and rift_tpu_torch (no JAX).
"""
from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 rate and f32 outside the
# tensor cores. Bounds below are stated against these at the 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

NUM_PAIRS = 16
NUM_POINTS = 1024
PARITY_PAIRS = 8
TIMED_BATCHES = 3

# Tolerances of the kernel checks (kernel vs plain version on the card).
# K1: neighbour counts must be equal (both compute d² with the same
# unfused expansion, so the radius masks agree bit for bit); the moments
# are sums of up to n terms in another order: relative error <= 1e-5 of
# the largest moment. K2: counts equal; means differ only by summation
# order (index_add_ uses atomics on the card): <= 1e-5 of the largest
# value. K3: same corner order and unfused multiply-add as the plain
# version: <= 1e-6 of the largest value.
TOL = {"normals_moments": 1e-5, "scatter_mean": 1e-5, "corner_gather": 1e-6}
# End-to-end parity, card vs CPU: share of points whose feature differs by
# more than 1e-3 of the largest feature (a one-ulp change in a voxel
# boundary or a ball-query radius test moves single points) <= 1%; share of
# mutual-NN mask entries that agree >= 0.99. Poses, for every pair whose
# pose the inputs determine: within 1e-3 (max abs entry) for Kabsch on the
# card at the CPU run's final GNC weights, for GNC-TLS on the same matches,
# and end to end where the masks agree. A pair is not determined when
# GNC-TLS on the CPU moves its pose by more than 1e-3 once the matches are
# nudged by 1e-6 (about 10 ulps): with one or two inliers (random weights)
# the optimum is not unique, and rounding picks the fixed point on either
# device. At least half of the pairs must be determined. Residuals, for
# every pair: over the matches both runs share, the card pose's TLS cost
# Σ min(r², c²)/c² may exceed the CPU pose's by at most 1 (one match's
# worth): both must be equally good TLS solutions.
FEAT_POINT_TOL, FEAT_POINT_SHARE = 1e-3, 0.01
MASK_AGREE = 0.99
TRANSFORM_TOL = 1e-3
NUDGE, NUDGE_TRIES = 1e-6, 4
TLS_COST_SLACK = 1.0


def tls_cost(transform, src, dst, mask, noise_bound: float):
    """Σ over the masked matches of min(r², c²)/c² under each pose [b]."""
    import torch

    moved = src @ transform[..., :3, :3].transpose(-1, -2) + transform[..., None, :3, 3]
    r2 = ((moved - dst) ** 2).sum(-1) / noise_bound ** 2
    return torch.where(mask, torch.clamp(r2, max=1.0), torch.zeros_like(r2)).sum(-1)


def phase(name: str, t0: float, msg: str) -> None:
    print(f"[{name}] {time.perf_counter() - t0:.3f} s  {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_time_ms(fn, reps: int = 20) -> float:
    """Median of `reps` CUDA-event timings of fn() after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(sorted(times)[len(times) // 2])


def short(t) -> list:
    """A tensor's values at 3 significant digits, for the log."""
    return [float(f"{float(x):.3g}") for x in t]


def rel_err(got, want) -> tuple[float, float]:
    """(max abs error, max abs error over the largest |want|)."""
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


def seeded_model(seed: int):
    """The flagship model (PVCNNClassifier's defaults are the configuration
    of checkpoints/mn40_sph_pt_r4) with weights and BN statistics drawn
    from a seeded torch.Generator (BN means around 0, variances in
    [0.5, 1.5])."""
    import torch

    from rift_tpu_torch.models import PVCNNClassifier

    model = PVCNNClassifier()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("coefficient"):
                p.copy_(0.5 + torch.rand(p.shape, generator=gen))
            elif ".bn" in name or ".bns." in name:
                base = 1.0 if name.endswith("weight") else 0.0
                p.copy_(base + 0.1 * (torch.rand(p.shape, generator=gen) - 0.5))
            elif p.dim() > 1:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=gen) * math.sqrt(2.0 / fan_in))
            else:
                p.copy_(0.05 * torch.randn(p.shape, generator=gen))
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.2 * (torch.rand(buf.shape, generator=gen) - 0.5))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))
    return model.eval()


def check_kernels(clouds, report: dict) -> None:
    """Each kernel vs its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from rift_tpu_torch.ops.cuda import normals_kernel as nk
    from rift_tpu_torch.ops.cuda import onehot_ops as oh
    from rift_tpu_torch.ops.spherical import (normalize_coords_sphere,
                                              spherical_corner_weights,
                                              spherical_voxel_indices)

    dev = clouds.device
    b, n, _ = clouds.shape
    r = 32
    s = r ** 3
    gen = torch.Generator(device=dev).manual_seed(1)

    # K1 at [2B, 1024, 3], k = 16, r² = 0.01.
    k, r2 = 16, 0.01
    got = nk.neighborhood_moments(clouds, k, r2)
    want = nk.neighborhood_moments_plain(clouds, k, r2)
    torch.cuda.synchronize()
    if not torch.equal(got[2], want[2]):
        fail(f"K1 neighbour counts differ at {int((got[2] != want[2]).sum())} queries")
    e1 = rel_err(torch.cat([g.reshape(b, n, -1) for g in got[:2]], -1),
                 torch.cat([w.reshape(b, n, -1) for w in want[:2]], -1))[1]
    abs1 = max(rel_err(got[0], want[0])[0], rel_err(got[1], want[1])[0])
    total_nbrs = float(want[2].sum())
    # d² 9 flops + 32 bisection steps x (compare, add) + bracket min 3 +
    # mask 1 per (query, point); 22 flops per neighbour for the moments.
    flops = b * n * n * (9 + 64 + 3 + 1) + 22 * total_nbrs
    bytes_ = b * n * 3 * 4 + b * n * 13 * 4
    report["normals_moments"] = dict(
        source="rift_tpu_torch/csrc/normals_moments.cu",
        replaces="rift_tpu/ops/pallas/normals_kernel.py:40",
        shapes=f"points [{b},{n},3] k={k}",
        max_abs_err=abs1, max_rel_err=e1, tol=TOL["normals_moments"],
        ms=cuda_time_ms(lambda: nk.neighborhood_moments(clouds, k, r2)),
        plain_ms=cuda_time_ms(lambda: nk.neighborhood_moments_plain(clouds, k, r2)),
        flops=flops, bytes=bytes_, library_ms=None)

    # K2 at c = 67 and c = 64 over the clouds' spherical voxel indices.
    norm = normalize_coords_sphere(clouds)
    inds, _ = spherical_voxel_indices(norm, r)
    inds32 = inds.to(torch.int32)
    valid = inds >= 0
    trash = torch.where(valid, inds, torch.full_like(inds, s))
    flat = (trash + torch.arange(b, device=dev)[:, None] * (s + 1)).reshape(-1)
    k2 = dict(max_abs_err=0.0, max_rel_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
              bytes=0, flops=0)
    for c in (67, 64):
        feat = torch.randn((b, n, c), generator=gen, device=dev)
        out, cnt = oh.scatter_mean(feat, inds32, s)
        want_out, want_cnt = oh.scatter_mean_plain(feat, inds, s)
        torch.cuda.synchronize()
        if not torch.equal(cnt, want_cnt):
            fail(f"K2 counts differ at c={c}")
        a, rel = rel_err(out, want_out)
        k2["max_abs_err"] = max(k2["max_abs_err"], a)
        k2["max_rel_err"] = max(k2["max_rel_err"], rel)
        k2["ms"] += cuda_time_ms(lambda: oh.scatter_mean(feat, inds32, s))
        k2["plain_ms"] += cuda_time_ms(lambda: oh.scatter_mean_plain(feat, inds, s))
        rows = feat.reshape(b * n, c)

        def library():  # one PyTorch call: index_reduce_ 'mean' into a trash row
            return torch.zeros((b * (s + 1), c), device=dev).index_reduce_(
                0, flat, rows, "mean", include_self=False)

        lib_out = library().reshape(b, s + 1, c)[:, :s]
        if rel_err(lib_out, want_out)[1] > TOL["scatter_mean"]:
            fail("K2 library yardstick disagrees with the plain version")
        k2["library_ms"] += cuda_time_ms(library)
        k2["bytes"] += b * n * c * 4 + b * n * 4 + b * s * c * 4 + b * s * 4
        k2["flops"] += int(valid.sum()) * c + b * s * c
    report["scatter_mean"] = dict(
        source="rift_tpu_torch/csrc/voxel_ops.cu",
        replaces="rift_tpu/ops/pallas/onehot_ops.py:44",
        shapes=f"features [{b},{n},67] and [{b},{n},64] -> [{b},{s},c]",
        tol=TOL["scatter_mean"], **k2)

    # K3 at c = 64 and c = 128 with the clouds' corner indices and weights.
    idx, w = spherical_corner_weights(norm, inds, r)
    idx32 = idx.to(torch.int32)
    touched = int(torch.unique((idx + torch.arange(b, device=dev)[:, None, None] * s)
                               [idx >= 0]).numel())
    k3 = dict(max_abs_err=0.0, max_rel_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
              bytes=0, flops=0)
    bag_idx = (torch.clamp(idx, min=0) + torch.arange(b, device=dev)[:, None, None] * s
               ).reshape(-1)
    bag_w = torch.where(idx >= 0, w, torch.zeros_like(w)).reshape(-1)
    offsets = torch.arange(0, b * n * 8, 8, device=dev)
    for c in (64, 128):
        grid = torch.randn((b, s, c), generator=gen, device=dev)
        out = oh.corner_gather(grid, idx32, w)
        want_out = oh.corner_gather_plain(grid, idx, w)
        torch.cuda.synchronize()
        a, rel = rel_err(out, want_out)
        k3["max_abs_err"] = max(k3["max_abs_err"], a)
        k3["max_rel_err"] = max(k3["max_rel_err"], rel)
        k3["ms"] += cuda_time_ms(lambda: oh.corner_gather(grid, idx32, w))
        k3["plain_ms"] += cuda_time_ms(lambda: oh.corner_gather_plain(grid, idx, w))
        table = grid.reshape(b * s, c)

        def library():  # one PyTorch call: a weighted-sum embedding bag
            return F.embedding_bag(bag_idx, table, offsets, mode="sum",
                                   per_sample_weights=bag_w)

        if rel_err(library().reshape(b, n, c), want_out)[1] > 1e-5:
            fail("K3 library yardstick disagrees with the plain version")
        k3["library_ms"] += cuda_time_ms(library)
        # Grid rows this run's corners touch, once each; indices, weights
        # and the output once.
        k3["bytes"] += touched * c * 4 + b * n * 8 * 8 + b * n * c * 4
        k3["flops"] += int((idx >= 0).sum()) * c * 2
    report["corner_gather"] = dict(
        source="rift_tpu_torch/csrc/voxel_ops.cu",
        replaces="rift_tpu/ops/pallas/onehot_ops.py:101",
        shapes=f"grid [{b},{s},64] and [{b},{s},128], corners [{b},{n},8]",
        tol=TOL["corner_gather"], **k3)

    for name, rep in report.items():
        bound_bytes = rep["bytes"] / PEAK_BYTES_PER_S * 1e3
        bound_ops = rep["flops"] / PEAK_F32_FLOP_PER_S * 1e3
        rep["bound_ms"] = max(bound_bytes, bound_ops)
        rep["bound_by"] = "bytes" if bound_bytes >= bound_ops else "operations"
        if rep["max_rel_err"] > rep["tol"]:
            fail(f"{name}: relative error {rep['max_rel_err']:.3e} > {rep['tol']:.0e}")
        print(f"  {name}: {rep['shapes']}: max abs err {rep['max_abs_err']:.3e}, "
              f"rel {rep['max_rel_err']:.3e} (tol {rep['tol']:.0e}); "
              f"kernel {rep['ms']:.4f} ms, plain {rep['plain_ms']:.4f} ms, "
              f"library {rep['library_ms']} ms, bound {rep['bound_ms']:.4f} ms "
              f"({rep['bound_by']})", flush=True)


def path_stages(model, src, dst):
    """The stages of register_batch up to the matches: (normals, features,
    match indices into dst, mutual-NN mask)."""
    import torch

    from rift_tpu_torch.ops.neighbors import mutual_nearest_neighbors
    from rift_tpu_torch.ops.normals import estimate_normals
    from rift_tpu_torch.ops.precision import f32_geometry

    with torch.no_grad(), f32_geometry():
        clouds = torch.cat([src, dst], 0)
        normals = estimate_normals(clouds)
        feats = model(torch.cat([clouds, normals], -1))
        b = src.shape[0]
        _, idx2, mask = mutual_nearest_neighbors(feats[:b], feats[b:])
    return normals, feats, idx2, mask


def main() -> int:
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke needs one CUDA card",
              file=sys.stderr, flush=True)
        return 2
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired, IndexError):
        smi = "nvidia-smi not available"
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    phase("device", t0, f"{kind}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
                        f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    from rift_tpu_torch.data import SyntheticPairs
    from rift_tpu_torch.ops.cuda import build, kernel_wrappers
    from rift_tpu_torch.ops.precision import f32_geometry
    from rift_tpu_torch.registration import (gnc_pose, pair_errors, register_batch,
                                             weighted_kabsch)
    from rift_tpu_torch.registration.pipeline import NOISE_BOUND

    build.load()
    phase("build", t0, f"{build.lib_path} built in {build.build_seconds:.2f} s")

    dev = torch.device("cuda")
    src_np, dst_np, gt_np = SyntheticPairs(num_pairs=NUM_PAIRS, num_points=NUM_POINTS,
                                           mode="noise", seed=0).arrays()
    src = torch.as_tensor(src_np, device=dev)
    dst = torch.as_tensor(dst_np, device=dev)
    gt = torch.as_tensor(gt_np, device=dev)

    t0 = time.perf_counter()
    report: dict = {}
    check_kernels(torch.cat([src, dst], 0), report)
    phase("kernels", t0, "all kernels agree with their plain versions")

    t0 = time.perf_counter()
    model = seeded_model(0).to(dev)
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    est = register_batch(model, src, dst)  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_BATCHES):
        t1 = time.perf_counter()
        est = register_batch(model, src, dst)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    batches = TIMED_BATCHES + 1
    per_batch = {"normals_moments": 1, "scatter_mean": 2, "corner_gather": 2}
    for name, want in per_batch.items():
        if launches[name] != want * batches:
            fail(f"{name} launched {launches[name]} times in {batches} batches, "
                 f"expected {want * batches}")
    if not bool(torch.isfinite(est).all()) or tuple(est.shape) != (NUM_PAIRS, 4, 4):
        fail(f"main path gave non-finite or misshapen transforms {tuple(est.shape)}")
    errs = pair_errors(src, gt, est)
    ms = sorted(times)[len(times) // 2] * 1e3
    phase("main", t0, f"{NUM_PAIRS} pairs x {NUM_POINTS} points: {ms:.2f} ms/batch "
                      f"(median of {TIMED_BATCHES}), {NUM_PAIRS / ms * 1e3:.2f} pairs/s; "
                      f"median RRE {float(errs['rre'].median()):.3f} deg, "
                      f"RTE {float(errs['rte'].median()):.4f} (random weights: "
                      f"information only); launches {launches}")

    t0 = time.perf_counter()
    p, b = PARITY_PAIRS, NUM_PAIRS
    cpu_model = copy.deepcopy(model).cpu()
    # Card side: the timed batch's shapes (16 pairs), sliced to the first p.
    n_g, f_g, idx_g, m_g = path_stages(model, src, dst)
    clouds = torch.cat([torch.arange(p), b + torch.arange(p)]).to(dev)
    n_g, f_g, t_g = n_g[clouds].cpu(), f_g[clouds].cpu(), est[:p].cpu()
    idx_g, m_g = idx_g[:p].cpu(), m_g[:p].cpu()
    n_c, f_c, idx_c, m_c = path_stages(cpu_model, src[:p].cpu(), dst[:p].cpu())
    t_c = register_batch(cpu_model, src_np[:p], dst_np[:p], device="cpu")
    # The solver alone on the CPU run's matches: on the card, and on the
    # CPU with the matches nudged, to find the pairs the inputs determine.
    src_c = src[:p].cpu()
    matched_c = torch.gather(dst[:p].cpu(), 1, idx_c[..., None].expand(-1, -1, 3))
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad(), f32_geometry():
        t_solver = gnc_pose(src[:p], matched_c.to(dev), m_c.to(dev),
                            noise_bound=NOISE_BOUND)[0].cpu()
        _, w_c = gnc_pose(src_c, matched_c, m_c, noise_bound=NOISE_BOUND)
        t_step = weighted_kabsch(src[:p], matched_c.to(dev), w_c.to(dev)).cpu()
        spread = torch.zeros(p)
        for _ in range(NUDGE_TRIES):
            nudged = matched_c + NUDGE * torch.randn(matched_c.shape, generator=gen)
            t_n = gnc_pose(src_c, nudged, m_c, noise_bound=NOISE_BOUND)[0]
            spread = torch.maximum(spread, (t_n - t_c).abs().amax((-2, -1)))
    determined = spread <= TRANSFORM_TOL
    normal_cos = float((n_g * n_c).sum(-1).abs().min())
    feat_abs, feat_rel = rel_err(f_g, f_c)
    point_err = (f_g - f_c).abs().amax(-1) / float(f_c.abs().max())
    bad_share = float((point_err > FEAT_POINT_TOL).float().mean())
    agree = float((m_g == m_c).float().mean())
    same_mask = (m_g == m_c).all(-1)
    t_diff = (t_g - t_c).abs().amax((-2, -1))
    solver_diff = (t_solver - t_c).abs().amax((-2, -1))
    step_diff = (t_step - t_c).abs().amax((-2, -1))
    shared = m_g & m_c & (idx_g == idx_c)
    cost_c = tls_cost(t_c, src_c, matched_c, shared, NOISE_BOUND)
    cost_g = tls_cost(t_g, src_c, matched_c, shared, NOISE_BOUND)
    cost_solver_c = tls_cost(t_c, src_c, matched_c, m_c, NOISE_BOUND)
    cost_solver_g = tls_cost(t_solver, src_c, matched_c, m_c, NOISE_BOUND)
    worse = torch.maximum(cost_g - cost_c, cost_solver_g - cost_solver_c)
    msg = (f"{p} pairs: min |cos| between normals {normal_cos:.6f}; features max abs err "
           f"{feat_abs:.3e} (rel {feat_rel:.3e}), share of points off by > "
           f"{FEAT_POINT_TOL:g} {bad_share:.4f} (tol {FEAT_POINT_SHARE}); mutual-NN "
           f"agreement {agree:.4f} (tol {MASK_AGREE}); transform max abs diff, Kabsch "
           f"at the CPU's GNC weights {short(step_diff)}, GNC-TLS on "
           f"the same matches {short(solver_diff)}, end to end "
           f"{short(t_diff)} (tol {TRANSFORM_TOL}; CPU pose spread "
           f"under a {NUDGE:g} nudge {short(spread)}, determined "
           f"{determined.tolist()}, masks agree {same_mask.tolist()}, CPU GNC inliers "
           f"{(w_c > 0.5).sum(-1).tolist()} of {m_c.sum(-1).tolist()} matches); TLS "
           f"cost over shared matches, card minus CPU, end to end "
           f"{short(cost_g - cost_c)}, solver "
           f"{short(cost_solver_g - cost_solver_c)} (tol {TLS_COST_SLACK})")
    if bad_share > FEAT_POINT_SHARE or agree < MASK_AGREE or not bool(torch.isfinite(t_c).all()):
        fail("parity: " + msg)
    if int(determined.sum()) * 2 < p or bool((worse > TLS_COST_SLACK).any()) \
            or bool((step_diff[determined] > TRANSFORM_TOL).any()) \
            or bool((solver_diff[determined] > TRANSFORM_TOL).any()) \
            or bool((t_diff[determined & same_mask] > TRANSFORM_TOL).any()):
        fail("parity: " + msg)
    phase("parity", t0, msg)

    kernels = []
    for name, rep in report.items():
        kernels.append({
            "name": name, "route": "cuda", "source": rep["source"],
            "replaces": rep["replaces"], "launches": launches[name],
            "max_abs_err": rep["max_abs_err"], "max_err": rep["max_abs_err"],
            "max_rel_err": rep["max_rel_err"], "tol": rep["tol"],
            "ms": rep["ms"], "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
            "shapes": rep["shapes"]})
    print(f"total {time.perf_counter() - t_all:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
