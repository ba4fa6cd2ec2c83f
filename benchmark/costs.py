"""Frozen operation and byte counts of the benchmark, and the cards' peaks.

A copy of the port's `train/roofline.py` counting and peaks, frozen here so
that no later change to the program moves the yardstick, and completed
with what the cells need:

- SharedMLP 256 and 512, the last two blocks of the trunk (`cost_shared_mlp`);
- the point branch of either kernel: `dgcnn_kernel` reads 2·c_in channels,
  `pointnet_kernel` c_in (`cost_pvconv`);
- the classifier's head (`cost_head`);
- the flagship evaluation's 5b-cloud flip forward and its 4 flip matchings
  (`register_flops`);
- a training step as 3 × its forward (`train_flops`);
- K5's bound at each launch's shapes, `chip_smoke.py`'s arithmetic
  (`k5_launches`).

A stage costs the same for the same shapes whatever implements it. The
robust pose solve is left out of the model FLOPs, so that a change that
removes or shortens a kernel cannot raise `mfu`: the time of the whole
call stays in its denominator.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ChipPeaks:
    """A card's peaks: FLOP/s in bf16 and f32, and HBM bytes/s."""
    name: str
    flops_bf16: float
    flops_f32: float
    hbm_bytes_per_s: float

    def flops(self, dtype: str) -> float:
        return self.flops_bf16 if dtype == "bfloat16" else self.flops_f32


# NVIDIA's data sheets, dense rates without sparsity, at the part's full
# power limit; lower-case substrings of torch.cuda.get_device_name, most
# specific first. f32 is the CUDA cores' rate: the configurations keep TF32 off.
_PEAKS = (
    ("h100 nvl", ChipPeaks("h100_nvl", 835e12, 60e12, 3.9e12)),
    ("h100 pcie", ChipPeaks("h100_pcie", 756e12, 51e12, 2.0e12)),
    ("h100 80gb hbm3", ChipPeaks("h100_sxm", 989e12, 67e12, 3.35e12)),
)


def peaks_for_name(name: str) -> ChipPeaks:
    """The peaks of the card that torch.cuda.get_device_name calls `name`;
    raises for a card without published peaks here."""
    kind = name.lower()
    for key, peaks in _PEAKS:
        if key in kind:
            return peaks
    raise ValueError(f"no published peaks for the card {name!r}")


@dataclass(frozen=True)
class StageCost:
    """Operations and HBM bytes of one stage at fixed shapes."""
    name: str
    flops: float
    bytes: float


F32, BF16 = 4, 2  # bytes


def _element(dtype: str | None) -> int:
    return BF16 if dtype == "bfloat16" else F32


def cost_normals(b: int, n: int, k: int = 16) -> StageCost:
    """estimate_normals' least work: per query-point pair d² (9 operations),
    a step of an exact selection and the radius test; 22 per neighbour for
    the 13 moments, min(k, n) neighbours a query; points read, moments
    written."""
    flops = b * n * n * (9 + 1 + 1) + 22 * b * n * min(k, n)
    return StageCost("normals", flops, F32 * b * n * (3 + 13))


def cost_local_ppf(b: int, n: int, k: int, fuse: tuple[int, int] = (32, 64),
                   dtype: str | None = None) -> StageCost:
    """Local-PPF branch: the ball query's n × n distances and
    SharedMLP(4 -> h1 -> h2) over k neighbours; points and normals read,
    [b, n, h2] written."""
    h1, h2 = fuse
    flops = 2 * b * n * n * 3 + 2 * b * n * k * (4 * h1 + h1 * h2)
    return StageCost("local_ppf", flops, F32 * b * n * 6 + _element(dtype) * b * n * h2)


def cost_pvconv(b: int, n: int, r: int, cin: int, cout: int, dgcnn: bool,
                dtype: str | None = None) -> StageCost:
    """One PVConv: 2 × Conv3d(k = 3) on [r, r, r] grids and the point
    branch SharedMLP (2·cin -> cout for dgcnn_kernel, cin -> cout for
    pointnet_kernel); bytes of the voxelize, the grids, the devoxelize and
    the point branch."""
    conv = 2 * b * r ** 3 * 27 * (cin * cout + cout * cout)
    pin = 2 * cin if dgcnn else cin
    point = 2 * b * n * pin * cout
    byts = _element(dtype) * b * (n * cin + r ** 3 * (cin + 2 * cout) + n * (8 * cout + cout)
                                  + n * (pin + cout))
    return StageCost(f"pvconv_r{r}_{cin}->{cout}", conv + point, byts)


def cost_shared_mlp(b: int, n: int, cin: int, cout: int, dtype: str | None = None) -> StageCost:
    """A one-layer SharedMLP over b·n points."""
    return StageCost(f"mlp_{cin}->{cout}", 2 * b * n * cin * cout,
                     _element(dtype) * b * n * (cin + cout))


def cost_head(b: int, c: int, classes: int) -> StageCost:
    """The classifier's head on the pooled features: Dense c -> 512 -> 256
    -> classes."""
    return StageCost("head", 2 * b * (c * 512 + 512 * 256 + 256 * classes),
                     F32 * b * (c + classes))


def cost_matching(pairs: int, n: int, c: int) -> StageCost:
    """Mutual NN: one n × n × c distance product per pair, and the argmins."""
    return StageCost("matching", 2 * pairs * n * n * c, F32 * pairs * (2 * n * c + n * n))


def trunk_costs(model: dict, clouds: int, n: int) -> list[StageCost]:
    """The feature trunk of the configuration's `model` block on `clouds`
    clouds of n points: local branch, PVConv and SharedMLP blocks."""
    dtype = model.get("dtype")
    dgcnn = model["point_kernel_formal"] == "dgcnn_kernel"
    in_ch = 3 + (4 if model.get("extra_feature_channels") == 4 else 0)
    out = []
    if model.get("with_local_feat") == "ppf":
        out.append(cost_local_ppf(clouds, n, model["local_neighbors"], dtype=dtype))
        in_ch += 64
    for width, blocks, resolution in model["blocks"]:
        for _ in range(blocks):
            if resolution is None:
                out.append(cost_shared_mlp(clouds, n, in_ch, width, dtype))
            else:
                out.append(cost_pvconv(clouds, n, resolution, in_ch, width, dgcnn, dtype))
            in_ch = width
    return out


def feature_width(model: dict) -> int:
    return model["blocks"][-1][0]


def register_flops(model: dict, pairs: int, n: int, flips: bool) -> float:
    """Model FLOPs of one registration call of `pairs` pairs: the normals of
    the 2b clouds, the trunk on 2b clouds (5b with the flip hypotheses: 4
    flips of each source and the targets) and the mutual-NN matching (4 flip
    matchings a pair with the flips). The pose solve is left out."""
    clouds = (5 if flips else 2) * pairs
    stages = [cost_normals(2 * pairs, n), *trunk_costs(model, clouds, n),
              cost_matching((4 if flips else 1) * pairs, n, feature_width(model))]
    return float(sum(s.flops for s in stages))


def train_flops(model: dict, clouds: int, n: int) -> float:
    """A training step as 3 × its forward: the trunk on the batch's clouds
    and the head."""
    stages = [*trunk_costs(model, clouds, n),
              cost_head(clouds, feature_width(model), model["num_classes"])]
    return 3.0 * float(sum(s.flops for s in stages))


def k5_launches(model: dict, clouds: int) -> list[tuple[float, float]]:
    """(operations, bytes) of each K5 launch of one bf16 eval forward on
    `clouds` clouds, `chip_smoke.py`'s arithmetic: 2·27·r³·cin·cout·b
    operations; the grids read and written in bf16 and the weight."""
    in_ch = 3 + (4 if model.get("extra_feature_channels") == 4 else 0)
    if model.get("with_local_feat") == "ppf":
        in_ch += 64
    out = []
    for width, blocks, resolution in model["blocks"]:
        for _ in range(blocks):
            if resolution is not None:
                for cin in (in_ch, width):
                    out.append((2.0 * 27 * resolution ** 3 * cin * width * clouds,
                                float(clouds * resolution ** 3 * (cin + width) * 2
                                      + 27 * cin * width * 2)))
            in_ch = width
    return out


def k5_bound_s(model: dict, clouds: int, peaks: ChipPeaks) -> float:
    """K5's least time for one forward: each launch's max(operations / bf16
    peak, bytes / HBM rate), summed."""
    return sum(max(f / peaks.flops_bf16, b / peaks.hbm_bytes_per_s)
               for f, b in k5_launches(model, clouds))
