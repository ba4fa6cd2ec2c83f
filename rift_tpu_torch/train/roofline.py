"""Per-stage roofline accounting, twin of `rift_tpu/train/roofline.py`.

Each stage's operations and HBM bytes are counted from its shapes, and
its least time on a card is

    t_min = max(flops / peak_flops, bytes / peak_bytes_per_s)

so a measured time gives `sol_fraction = t_min / t_measured` (1.0 is the
card's limit) and `mfu = flops / (t_measured * peak_flops)`.
`chip_smoke.py`'s kernel bounds read the same peaks (`chip_peaks`).

Peaks are per card, from NVIDIA's data sheets, dense rates without
sparsity, at the part's full power limit: the H100 SXM ("NVIDIA H100 80GB
HBM3"), 989e12 bf16 FLOP/s on the tensor cores, 67e12 f32 FLOP/s (the
port keeps TF32 off for its geometry, so f32 runs on the CUDA cores) and
3.35e12 B/s of HBM3; the H100 PCIe, 756e12, 51e12 and 2.0e12; the H100
NVL, 835e12, 60e12 and 3.9e12. Another CUDA card raises: there are no
made-up peaks. `device="cpu"` gives the reference's placeholder peaks, so
that the accounting runs in the CPU tests; its numbers mean nothing.

Counting rule: a stage costs the same for the same shapes whatever
implements it, so a bound stays valid when the code under it changes.
Kept from the reference: PVConv's convolution and point-branch
operations, matching's operations and bytes, and `cost_gnc` whole.
Departures (counts at `flagship_costs`' shapes: 64 pairs, 128 clouds of
1024 points, local k = 128, 512-wide features, bf16):

- `cost_normals` counts K1's least work, not the reference's [n, n] mask
  matmuls and the mask written: 11 operations for each query-point pair
  (d² 9, a step of an exact selection, the radius test) and 22 for each
  neighbour (the 13 moments), with `k` neighbours a query as the floor
  (`estimate_normals`' `min_neighbors`) unless the run's count is given;
  bytes are the points read and the 13 moments written. 1.5225e9
  operations and 8.39e6 bytes (reference: 4.0265e9 and 5.4474e8).
- `cost_local_ppf` has no one-hot gather (2·b·n·k·n·6 in the reference)
  and no materialized activations: operations are the ball query's
  distances and SharedMLP[32, 64] over the k neighbours; bytes are the
  points and normals read (f32) and the fused features written. 7.3820e10
  operations and 1.9923e7 bytes (reference: 2.7998e11 and 7.1135e9).
- Bytes are counted at the element size of the dtype the stage moves (2
  for bf16; coordinates stay f32); the reference counts 4 everywhere.
  PVConv 71→64 moves 1.8929e9 bytes (reference 3.7859e9), 64→128
  3.0702e9 (6.1405e9).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device


@dataclass(frozen=True)
class ChipPeaks:
    """A card's peaks: FLOP/s in bf16 and f32, and HBM bytes/s (the
    reference's field name, `hbm_gbps`, holds bytes per second)."""
    name: str
    flops_bf16: float
    flops_f32: float
    hbm_gbps: float


# Lower-case substrings of torch.cuda.get_device_name, most specific first.
_PEAKS = (
    ("h100 nvl", ChipPeaks("h100_nvl", 835e12, 60e12, 3.9e12)),
    ("h100 pcie", ChipPeaks("h100_pcie", 756e12, 51e12, 2.0e12)),
    ("h100 80gb hbm3", ChipPeaks("h100_sxm", 989e12, 67e12, 3.35e12)),
)
PLACEHOLDER = ChipPeaks("placeholder (cpu)", 1e12, 0.5e12, 100e9)


def peaks_for_name(name: str) -> ChipPeaks:
    """The peaks of the card that torch.cuda.get_device_name calls `name`;
    raises for a card without published peaks here."""
    kind = name.lower()
    for key, peaks in _PEAKS:
        if key in kind:
            return peaks
    raise ValueError(f"no published peaks for the card {name!r} "
                     f"(known: {', '.join(key for key, _ in _PEAKS)})")


def chip_peaks(device: str | torch.device | None = None) -> ChipPeaks:
    """The peaks of `device`: None is the CUDA card (raises without one),
    "cpu" the placeholder."""
    device = resolve_device(device)
    if device.type == "cpu":
        return PLACEHOLDER
    return peaks_for_name(torch.cuda.get_device_name(device))


@dataclass
class StageCost:
    """FLOPs + HBM bytes for one stage at fixed shapes (per call)."""
    name: str
    flops: float
    bytes: float
    dtype: str = "f32"  # dominant dot dtype: 'bf16' | 'f32'

    def t_min(self, peaks: ChipPeaks) -> float:
        peak_f = peaks.flops_bf16 if self.dtype == "bf16" else peaks.flops_f32
        return max(self.flops / peak_f, self.bytes / peaks.hbm_gbps)

    def report(self, measured_s: float, peaks: ChipPeaks) -> dict:
        peak_f = peaks.flops_bf16 if self.dtype == "bf16" else peaks.flops_f32
        t_min = self.t_min(peaks)
        return {
            "stage": self.name,
            "measured_ms": round(measured_s * 1e3, 3),
            "flops_g": round(self.flops / 1e9, 2),
            "hbm_gb": round(self.bytes / 1e9, 3),
            "bound": ("compute" if self.flops / peak_f
                      >= self.bytes / peaks.hbm_gbps else "memory"),
            "t_min_ms": round(t_min * 1e3, 3),
            "sol_fraction": round(t_min / max(measured_s, 1e-12), 4),
            "mfu": round(self.flops / (max(measured_s, 1e-12) * peak_f), 4),
        }


F32 = 4  # bytes
BF16 = 2


def _element(bf16: bool) -> int:
    return BF16 if bf16 else F32


def cost_normals(b: int, n: int, k: int = 16, neighbours: float | None = None) -> StageCost:
    """estimate_normals' least work (K1's): per query-point pair d² (9
    operations), a step of an exact selection and the radius test; 22 per
    neighbour for the 13 moments, `neighbours` in all (the run's count) or
    min(k, n) a query; the points read and the moments written."""
    if neighbours is None:
        neighbours = b * n * min(k, n)
    flops = b * n * n * (9 + 1 + 1) + 22 * neighbours
    byts = F32 * b * n * (3 + 13)
    return StageCost("normals", flops, byts)


def cost_local_ppf(b: int, n: int, k: int, fuse: tuple[int, int] = (32, 64),
                   bf16: bool = False) -> StageCost:
    """Local-PPF branch: the ball query's n x n distances, 4-d PPF
    (elementwise, not counted), SharedMLP(4->h1->h2) over k neighbours,
    masked max; reads points and normals, writes [b, n, h2]."""
    dist = 2 * b * n * n * 3
    h1, h2 = fuse
    mlp = 2 * b * n * k * (4 * h1 + h1 * h2)
    byts = F32 * b * n * 6 + _element(bf16) * b * n * h2
    return StageCost("local_ppf", dist + mlp, byts, "bf16" if bf16 else "f32")


def cost_pvconv(b: int, n: int, r: int, cin: int, cout: int,
                bf16: bool = False) -> StageCost:
    """One PVConv: voxelize scatter-mean (bw), 2x Conv3d(k=3) on [r,r,r]
    grids, trilinear devox (bw), dgcnn point branch SharedMLP(2cin->cout)."""
    conv = 2 * b * r**3 * 27 * (cin * cout + cout * cout)
    point = 2 * b * n * (2 * cin) * cout
    byts = _element(bf16) * b * (n * cin              # voxelize read
                                 + r**3 * (cin + 2 * cout)  # grids
                                 + n * (8 * cout + cout)    # devox gather + out
                                 + n * (2 * cin + cout))    # point branch
    return StageCost(f"pvconv_r{r}_{cin}->{cout}", conv + point, byts,
                     "bf16" if bf16 else "f32")


def cost_matching(pairs: int, n: int, c: int) -> StageCost:
    """Mutual-NN: one n x n x c distance dot per pair + argmins."""
    flops = 2 * pairs * n * n * c
    byts = F32 * pairs * (2 * n * c + n * n)
    return StageCost("matching", flops, byts)


def cost_gnc(pairs: int, n: int, iters: int = 45) -> StageCost:
    """GNC-TLS: per iteration a residual pass + weighted Kabsch (n x 3
    reductions), small bandwidth-bound operations."""
    flops = pairs * iters * (n * 40)
    byts = F32 * pairs * iters * n * 12
    return StageCost("gnc", flops, byts)


def flagship_costs(batch_pairs: int = 64, n: int = 1024, k: int = 128,
                   dim_k: int = 512, bf16: bool = True) -> dict[str, StageCost]:
    """Stage costs at bench.py's shapes (2 * batch_pairs clouds through
    the forward; blocks (64,32),(128,32),(256,-),(512,-)); `k` is the
    local branch's neighbours (the normals take estimate_normals' 16)."""
    b = 2 * batch_pairs
    return {
        "normals": cost_normals(b, n),
        "local_ppf": cost_local_ppf(b, n, k, bf16=bf16),
        "pvconv1": cost_pvconv(b, n, 32, 7 + 64, 64, bf16=bf16),
        "pvconv2": cost_pvconv(b, n, 32, 64, 128, bf16=bf16),
        "matching": cost_matching(batch_pairs, n, dim_k),
        "gnc": cost_gnc(batch_pairs, n),
    }
