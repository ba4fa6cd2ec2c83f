"""Training and evaluation configuration: the dataclasses `train()` and
`evaluate_registration()` read, copied from `rift_tpu/train/config.py`
(`ModelConfig`, `OptimConfig`, `TrainConfig`, `EvalConfig`,
`ExperimentConfig`; `ModelNet40Config` is in `data/modelnet40.py`,
`SequenceConfig` in `data/sequences.py`), the presets, and
`apply_overrides` (the command line's `a.b=v`). The presets:

- `mn40_sph_pt_r4`: the flagship, the values of
  `checkpoints/mn40_sph_pt_r4/best_acc.meta.json` (kept in code: the chip
  tool's copy of the repo leaves `checkpoints/` out), except `ckpt_dir`,
  which points beside the reference's checkpoint, never into it;
- `tiny_smoke`: the reference's CPU smoke widths, with the flagship's
  `pointnet_kernel` and `lrf_kind='pca'` (the reference's preset keeps
  the `dgcnn_kernel` default);
- the reference's presets, each equal to the reference's on every field
  the port has: the classifiers `mn40_{sph,cu}_{dg,pt}`; the registration
  sweep `reg_{clean,noise,partial,icl_nuim}_{ransac,fgr,teaserpp}_cu_
  {dg,pt}`; and the recommended `reg_clean`, `reg_noise`, `reg_partial`
  and `reg_icl_nuim` (cube, `dgcnn_kernel`, 4 global-PPF channels, the
  reference LRF, `ransac+picp`; the `icl_nuim` ones with the scans'
  solver settings); and `shapenet_seg`, the part segmentation trainer's
  (`train/loop.py:train_segmentation`: 8 clouds of 2048 points, 50 part
  classes, no SE).

The dataclasses have slots, so setting a field the port lacks raises. Of
the reference's fields only `train.log_every` (a logging cadence) is left
out. `train.half_precision` is kept as the reference keeps it, read by
nothing: bf16 training is `model.dtype='bfloat16'`. `train.data_parallel`
is read by `train()` under a process group (`train/loop.py:
make_distributed_step`), `dataset.cache_npy` by the ModelNet40 file
loader. `EvalConfig` has every field of the reference's with its default.
"""
from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field
from typing import Any

from ..data.modelnet40 import ModelNet40Config
from ..data.sequences import SequenceConfig


@dataclass(slots=True)
class ModelConfig:
    blocks: tuple = ((64, 1, 32), (128, 1, 32), (256, 1, None), (512, 1, None))
    dim_k: int = 512
    num_classes: int = 40
    point_kernel_formal: str = "dgcnn_kernel"
    voxel_shape: str = "spherical"
    with_coeff: bool = True
    with_se: bool = True
    extra_feature_channels: int = 0
    width_multiplier: float = 1.0
    voxel_resolution_multiplier: float = 1.0
    is_classify: bool = True
    rot_invariant_preprocess: str | None = "change_coords"
    lrf_kind: str = "reference"
    with_local_feat: str | None = "ppf"
    with_transform_fine_tune: bool = False
    use_new_coords_for_voxel: bool = False
    local_neighbors: int = 128
    dtype: str | None = None


@dataclass(slots=True)
class OptimConfig:
    lr: float = 1e-3
    weight_decay: float = 1e-6
    num_epochs: int = 250
    schedule: str = "cosine"
    grad_clip: float | None = None


@dataclass(slots=True)
class TrainConfig:
    batch_size: int = 16
    eval_batch_size: int = 32
    valid_interval: int = 1
    steps_per_epoch: int | None = None  # cap (useful for smoke runs)
    ckpt_dir: str = "checkpoints"
    # Read by nothing, as in the reference (rift_tpu/train/config.py:72):
    # training stays f32 when it is set. bf16 training is model.dtype.
    half_precision: bool = False
    # Data-parallel training over the ranks of a torch.distributed process
    # group (torchrun), one card a rank, when the group has more than one
    # rank and batch_size divides by it (train/loop.py:make_distributed_step).
    # False trains each rank alone on the whole batch.
    data_parallel: bool = True
    # At each validation epoch whose number (epoch + 1) K divides, register
    # reg_probe_pairs synthetic noise pairs with the current trunk and track
    # rre, rte, ... as best metrics (train/loop.py:registration_probe).
    # 0 = off.
    reg_probe_interval: int = 0
    reg_probe_pairs: int = 16


@dataclass(slots=True)
class EvalConfig:
    """Registration evaluation (`train/loop.py:evaluate_registration`).
    `method`: one of `registration.METHODS` ('ransac', 'fgr', 'teaserpp',
    'icp', the first three with a '+icp', '+picp' or '+pl' refiner).
    `inlier_threshold`, `num_hypotheses`, `ransac_irls` and
    `ransac_irls_shrink` set RANSAC (its inlier distance, hypotheses, Tukey
    IRLS steps, and the scale of two tighter steps when not 1).
    `noise_bound` sets TEASER and FGR (twice it), the consensus (tau = twice
    it) and the '+pl' gate (three times it). `pairs_path`: an h5 test file;
    when None or not a file, pairs of `pairs_mode`: synthetic 'clean',
    'noise', 'partial' or 'partialK' (K the source's overlap fraction, e.g.
    'partial0.5'), or 'icl_nuim', adjacent scans of the indoor sequence.
    `batch_pairs`: pairs per batch, the tail padded. `canonical_voxel`: voxelize in the LRF
    frame (`use_new_coords_for_voxel` on a checkpoint's change_coords
    trunk). `flip_hypotheses`: source features under the 4 sign
    assignments of its LRF, the most rigid matching kept
    (`registration/consensus.py`)."""
    method: str = "teaserpp"
    pairs_path: str | None = None
    pairs_mode: str = "noise"
    num_pairs: int = 100
    num_points: int = 1024
    noise_bound: float = 0.02
    inlier_threshold: float = 0.08
    num_hypotheses: int = 1000
    ransac_irls: int = 3
    ransac_irls_shrink: float = 1.0
    batch_pairs: int = 64
    ckpt_dir: str | None = None
    ckpt_name: str = "common"
    canonical_voxel: bool = True
    flip_hypotheses: bool = True


@dataclass(slots=True)
class ExperimentConfig:
    name: str = "mn40_sph_dg"
    seed: int = 0
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    dataset: ModelNet40Config = field(default_factory=ModelNet40Config)
    evaluate: EvalConfig = field(default_factory=EvalConfig)
    sequence: SequenceConfig = field(default_factory=SequenceConfig)


def _classification(voxel_shape: str, kernel: str) -> ExperimentConfig:
    cfg = ExperimentConfig(
        name=f"mn40_{'sph' if voxel_shape == 'spherical' else 'cu'}_"
             f"{'dg' if kernel == 'dgcnn_kernel' else 'pt'}")
    cfg.model.voxel_shape = voxel_shape
    cfg.model.point_kernel_formal = kernel
    return cfg


def _registration(method: str, mode: str, kernel: str = "dgcnn_kernel") -> ExperimentConfig:
    """A registration preset on the cube trunk: feature-extractor mode with
    4 global-PPF channels, `method` on `mode` pairs."""
    cfg = _classification("cube", kernel)
    cfg.name = f"reg_{mode}_{method}"
    cfg.model.is_classify = False
    cfg.model.extra_feature_channels = 4
    cfg.evaluate.method = method
    cfg.evaluate.pairs_mode = mode
    if mode == "icl_nuim":
        # The reference's calibration on the adjacent-scan pairs, where the
        # scans' resampling offsets set the noise.
        cfg.evaluate.noise_bound = 0.05
        cfg.evaluate.inlier_threshold = 0.07
        cfg.evaluate.num_hypotheses = 4000
    return cfg


def _reference_presets() -> dict[str, ExperimentConfig]:
    out = {}
    for voxel_shape in ("spherical", "cube"):
        for kernel in ("dgcnn_kernel", "pointnet_kernel"):
            cfg = _classification(voxel_shape, kernel)
            out[cfg.name] = cfg
    for mode in ("clean", "noise", "partial", "icl_nuim"):
        for method in ("ransac", "fgr", "teaserpp"):
            for kernel, suffix in (("dgcnn_kernel", "cu_dg"), ("pointnet_kernel", "cu_pt")):
                cfg = _registration(method, mode, kernel)
                cfg.name = f"reg_{mode}_{method}_{suffix}"
                out[cfg.name] = cfg
    for mode in ("clean", "noise", "partial", "icl_nuim"):
        best = _registration("ransac+picp", mode)
        best.name = f"reg_{mode}"
        out[best.name] = best
    seg = ExperimentConfig(name="shapenet_seg")
    seg.model.num_classes = 50
    seg.model.with_se = False
    seg.dataset.num_points = 2048
    seg.train.batch_size = 8
    out[seg.name] = seg
    return out


def presets() -> dict[str, ExperimentConfig]:
    flagship = ExperimentConfig(name="mn40_sph_pt")
    flagship.model.point_kernel_formal = "pointnet_kernel"
    flagship.model.lrf_kind = "pca"
    flagship.optim.num_epochs = 120
    flagship.train.ckpt_dir = "checkpoints/mn40_sph_pt_r4_torch"
    flagship.dataset.synthetic_items = {"train": 2048, "valid": 512, "test": 512}

    tiny = ExperimentConfig(name="tiny_smoke")
    tiny.model.point_kernel_formal = "pointnet_kernel"
    tiny.model.lrf_kind = "pca"
    tiny.model.blocks = ((16, 1, 8), (32, 1, None))
    tiny.model.dim_k = 32
    tiny.model.local_neighbors = 16
    tiny.dataset.num_points = 64
    tiny.dataset.synthetic_items = {"train": 32, "valid": 16, "test": 16}
    tiny.train.batch_size = 4
    tiny.optim.num_epochs = 2
    return {"mn40_sph_pt_r4": flagship, "tiny_smoke": tiny, **_reference_presets()}


def get_config(name: str) -> ExperimentConfig:
    table = presets()
    if name not in table:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(table)}")
    return table[name]


def apply_overrides(cfg: Any, overrides: list[str]) -> Any:
    """Set each dot path of `overrides` ('model.dim_k=256',
    "evaluate.method='ransac'") on `cfg` in place, the value read by
    `ast.literal_eval`, or kept as a bare string when it is no literal.
    Raises ValueError on an item without '=' and AttributeError on a field
    the dataclass lacks."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} must look like a.b=value")
        path, raw = item.split("=", 1)
        keys = path.strip().lstrip("-").split(".")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        node = cfg
        for key in keys[:-1]:
            node = getattr(node, key)
        leaf = keys[-1]
        if dataclasses.is_dataclass(node) and leaf not in {
                f.name for f in dataclasses.fields(node)}:
            raise AttributeError(f"{type(node).__name__} has no field {leaf!r}")
        setattr(node, leaf, value)
    return cfg
