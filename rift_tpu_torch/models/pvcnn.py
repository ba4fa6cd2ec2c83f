"""PVCNN rotation-invariant classifier and feature extractor, twin of
`rift_tpu/models/pvcnn.py:PVCNNClassifier`.

Ported: centring; the 'change_coords' preprocess (`lrf_kind` 'pca' or
'reference', or a basis given to `forward` as `lrf`), with
`extra_feature_channels=4` appending the global PPF of
each point (features [new_coords, global_ppf], 7 channels); the other
preprocesses of the reference (`invariant_features`): 'ppf' (the global
PPF, 4 channels), 'new_ppf' (it and the median pairwise azimuth, 5),
'pca' (`pca_align`, 3) and None (the raw inputs, `in_channels` of them:
flax reads the width from the input, a torch model is built with it);
`use_new_coords_for_voxel`, which voxelizes the canonical coordinates
instead of the centred raw ones (the local-PPF branch stays in the raw
frame, as in the reference); the local-PPF
branch in both modes (eval: ball-query grouping with masked empty slots;
train: `ball_query` with its duplicate padding, so BatchNorm sees the
reference's rows); the backbone of spherical or cube PVConv blocks
(`pointnet_kernel` or `dgcnn_kernel` point branch; the cube grid with
`normalize=False`, as the reference builds it) and SharedMLP blocks; and, with
`is_classify=True`, the head max-pool -> Dense 512 -> BN -> ReLU ->
Dropout 0.2 -> Dense 256 -> BN -> ReLU -> Dense num_classes.

The other local features of the reference, each in the raw centred frame
like the local PPF: 'fpfh' (`ops/fpfh.py` on the coordinates and normals,
k = 64 within `local_radius`, then SharedMLP[fuse, fuse] on the 33
channels, no max) and 'change_coords' (`ball_query` with its duplicate
padding in train and eval alike, each neighbourhood in its own
`local_lrf`, SharedMLP[32, fuse], max over k; no normals needed). And
`with_transform_fine_tune`, the 6-D rotation block of the 'change_coords'
preprocess: SharedMLP[32, 32] on the raw centred coordinates (not the
canonical ones, as in the reference, so the fine-tuned frame is not
rotation-invariant), max over points, Dense 16, BN, ReLU, Dense 6, the
two 3-vectors normalized and Gram-Schmidt to a rotation (columns b1, b2,
b1 × b2) that turns the canonical coordinates; the result is the
features and, with `use_new_coords_for_voxel`, the voxel coordinates.
These three blocks compute in f32 in a bf16 model too, as the
reference's (built without its `dtype`).

`dtype="bfloat16"` is the reference's bf16 mode (bench.py's model): every
SharedMLP and PVConv computes in bf16 with f32 parameters, while the
geometry (LRF, PPF, voxel binning) stays f32. The local-PPF features are
computed in f32 and rounded to bf16 by the fuser's first Dense, which is
the function of the reference's bf16 eval path
(`ops/ppf.py:local_ppf_grouped_fast`) up to one f32 reassociation; the
masked max fills with the bf16 minimum. Features leave the trunk as f32.

Submodules carry the flax module names, in flax's order of creation, so
`weights.from_flax` maps a flax tree by name alone: the fine-tune block's
`SharedMLP_0`, `Dense_0`, `BatchNorm_0`, `Dense_1` in `self.fine_tune`
(never under `head`, which the registration extractor drops); then the
local fuser's and the backbone's `SharedMLP_i` and `PVConv_i` in
`self.layers`; the head's `Dense_i` and `BatchNorm_i` (after the
fine-tune's, when there is one) in `self.head`.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from .. import tracing
from ..nn.batch_norm import BatchNorm
from ..nn.dropout import train_dropout
from ..nn.pvconv import PVConv
from ..nn.shared_mlp import SharedMLP
from ..ops.fpfh import fpfh
from ..ops.lrf import change_coords, global_lrf, local_lrf, lrf_basis, pca_align
from ..ops.neighbors import ball_query, ball_query_group, grouping
from ..ops.ppf import global_ppf, local_ppf, new_ppf

DEFAULT_BLOCKS = ((64, 1, 32), (128, 1, 32), (256, 1, None), (512, 1, None))
DTYPES = {None: None, "bfloat16": torch.bfloat16}
PREPROCESSES = ("change_coords", "ppf", "new_ppf", "pca", None)
LOCAL_FEATURES = ("ppf", "fpfh", "change_coords", None)
# The widths of the preprocesses that need no model field to size them.
INVARIANT_CHANNELS = {"ppf": 4, "new_ppf": 5, "pca": 3}


def invariant_features(mode: str, coords: torch.Tensor,
                       normals: torch.Tensor | None) -> torch.Tensor:
    """The preprocess `mode` of INVARIANT_CHANNELS on coords [b, n, 3]
    (and normals, which 'ppf' and 'new_ppf' need)."""
    if mode == "pca":
        return pca_align(coords)
    if normals is None:
        raise ValueError(f"the {mode!r} preprocess needs normals: inputs [b, n, 6]")
    return global_ppf(coords, normals) if mode == "ppf" else new_ppf(coords, normals)


class PVCNNClassifier(nn.Module):
    """Field names and defaults mirror `rift_tpu.models.PVCNNClassifier`
    (the flagship, checkpoints/mn40_sph_pt_r4, is `point_kernel_formal=
    "pointnet_kernel", lrf_kind="pca"`, and its feature extractor
    `is_classify=False`). Input
    [b, n, 6] (xyz + normals) -> per-point features [b, n, last width], or
    logits [b, num_classes] with `is_classify=True`. On the card, run it
    inside `ops/precision.py:f32_geometry` (as `register_batch` and
    `train.steps.train_step` do): cuDNN runs Conv3d in TF32 by default.
    `dropout` is the head's rate (the reference's 0.2); in train mode its
    mask is drawn from the `generator` given to `forward` (under
    `group`, the global batch's mask, this rank's rows). `dtype` is None
    (f32) or "bfloat16", as the reference's field. `in_channels` is the
    inputs' width, read by the preprocess None alone. `with_local_feat` is
    one of LOCAL_FEATURES; `with_transform_fine_tune` adds the fine-tune
    block to a 'change_coords' preprocess (the reference ignores it under
    the others, and so does this model)."""

    def __init__(self, blocks: Sequence[tuple[int, int, int | None]] = DEFAULT_BLOCKS,
                 dim_k: int = 512,
                 num_classes: int = 40,
                 point_kernel_formal: str = "dgcnn_kernel",
                 voxel_shape: str = "spherical",
                 with_coeff: bool = True, with_se: bool = True,
                 extra_feature_channels: int = 0,
                 width_multiplier: float = 1.0,
                 voxel_resolution_multiplier: float = 1.0,
                 is_classify: bool = True,
                 rot_invariant_preprocess: str | None = "change_coords",
                 lrf_kind: str = "reference",
                 with_local_feat: str | None = "ppf",
                 local_radius: float = 0.3, local_neighbors: int = 128,
                 local_fuse_dim: int = 64,
                 dropout: float = 0.2,
                 dtype: str | None = None,
                 use_new_coords_for_voxel: bool = False,
                 in_channels: int = 6,
                 with_transform_fine_tune: bool = False):
        super().__init__()
        if rot_invariant_preprocess not in PREPROCESSES:
            raise ValueError(f"unknown rot_invariant_preprocess {rot_invariant_preprocess!r}")
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be None or 'bfloat16', got {dtype!r}")
        if with_local_feat not in LOCAL_FEATURES:
            raise ValueError(f"unknown with_local_feat {with_local_feat!r}")
        del dim_k  # the last block's width is the feature width, as in the reference
        self.rot_invariant_preprocess = rot_invariant_preprocess
        self.lrf_kind = lrf_kind
        self.use_new_coords_for_voxel = use_new_coords_for_voxel
        self.global_ppf = extra_feature_channels == 4
        self.local_radius = local_radius
        self.local_neighbors = local_neighbors
        self.dtype = DTYPES[dtype]
        layers = {}
        if rot_invariant_preprocess == "change_coords":
            in_ch = 7 if self.global_ppf else 3
        else:
            in_ch = INVARIANT_CHANNELS.get(rot_invariant_preprocess, in_channels)
        n_mlp = n_dense = n_bn = 0
        self.fine_tune = None
        if with_transform_fine_tune and rot_invariant_preprocess == "change_coords":
            self.fine_tune = nn.ModuleDict({
                "SharedMLP_0": SharedMLP(3, [32, 32]), "Dense_0": nn.Linear(32, 16),
                "BatchNorm_0": BatchNorm(16), "Dense_1": nn.Linear(16, 6)})
            n_mlp, n_dense, n_bn = 1, 2, 1
        self.with_local_feat = with_local_feat
        self._local = None
        if with_local_feat is not None:
            # The local PPF fuser computes in the model's dtype; the other
            # two are built without it, as in the reference.
            in_local, widths, dtype_local = {
                "ppf": (4, [32, local_fuse_dim], self.dtype),
                "fpfh": (33, [local_fuse_dim, local_fuse_dim], None),
                "change_coords": (3, [32, local_fuse_dim], None)}[with_local_feat]
            self._local = f"SharedMLP_{n_mlp}"
            layers[self._local] = SharedMLP(in_local, widths, dtype=dtype_local)
            n_mlp += 1
            in_ch += local_fuse_dim
        self._backbone: list[str] = []
        n_pv = 0
        for out_ch, num_blocks, resolution in blocks:
            out_ch = int(out_ch * width_multiplier)
            for _ in range(num_blocks):
                if resolution is None:
                    name = f"SharedMLP_{n_mlp}"
                    layers[name] = SharedMLP(in_ch, [out_ch], dtype=self.dtype)
                    n_mlp += 1
                else:
                    name = f"PVConv_{n_pv}"
                    layers[name] = PVConv(
                        in_ch, out_ch, point_kernel_formal=point_kernel_formal,
                        voxel_shape=voxel_shape,
                        resolution=int(resolution * voxel_resolution_multiplier),
                        with_coeff=with_coeff, with_se=with_se,
                        normalize=False,  # as the reference's model builds its blocks
                        dtype=self.dtype)
                    n_pv += 1
                self._backbone.append(name)
                in_ch = out_ch
        self.layers = nn.ModuleDict(layers)
        self.out_channels = in_ch
        self.head = None
        self.group = None  # set by parallel.sharded_ops for a data-parallel step
        if is_classify:
            w1, w2 = int(512 * width_multiplier), int(256 * width_multiplier)
            self._head = [f"Dense_{n_dense}", f"BatchNorm_{n_bn}", f"Dense_{n_dense + 1}",
                          f"BatchNorm_{n_bn + 1}", f"Dense_{n_dense + 2}"]
            self.head = nn.ModuleDict(zip(self._head, (
                nn.Linear(in_ch, w1), BatchNorm(w1), nn.Linear(w1, w2), BatchNorm(w2),
                nn.Linear(w2, num_classes))))
            self.dropout = dropout

    def forward(self, inputs: torch.Tensor, generator: torch.Generator | None = None,
                lrf: torch.Tensor | None = None) -> torch.Tensor:
        """`lrf` [b, 3, 3] (rows = axes), when given, replaces the basis
        `lrf_basis(coords, lrf_kind)` of the 'change_coords' preprocess (the
        flip hypotheses of `train.loop.evaluate_registration`)."""
        coords = inputs[..., :3]
        coords = coords - coords.mean(-2, keepdim=True)
        normals = inputs[..., 3:6] if inputs.shape[-1] >= 6 else None
        voxel_coords = coords
        mode = self.rot_invariant_preprocess
        if mode == "change_coords":
            basis = lrf if lrf is not None else lrf_basis(coords, self.lrf_kind)
            features = change_coords(coords, basis)
            if self.fine_tune is not None:
                features = self.transform_fine_tune(coords, features)
            if self.use_new_coords_for_voxel:
                voxel_coords = features
            if self.global_ppf:
                if normals is None:
                    raise ValueError("PPF features need normals: inputs [b, n, 6]")
                features = torch.cat([features, global_ppf(coords, normals)], dim=-1)
        elif mode is None:
            features = inputs
        else:
            features = invariant_features(mode, coords, normals)
        if self._local is not None:
            features = torch.cat([features, self.local_features(coords, normals)], dim=-1)
        for name in self._backbone:
            layer = self.layers[name]
            features = (layer(features, voxel_coords) if isinstance(layer, PVConv)
                        else layer(features))
        if self.head is None:
            return features.float()
        h = [self.head[name] for name in self._head]
        pooled = features.amax(-2).to(h[0].weight.dtype)  # bf16 features: f32 head
        x = torch.relu(h[1](h[0](pooled)))
        if self.training and self.dropout > 0.0:
            x = train_dropout(x, self.dropout, generator, self.group)
        x = torch.relu(h[3](h[2](x)))
        return h[4](x)

    def transform_fine_tune(self, coords: torch.Tensor, features: torch.Tensor) -> torch.Tensor:
        """The fine-tune block: a rotation [b, 3, 3] read from the raw
        centred `coords` [b, n, 3], applied to `features` [b, n, 3] (the
        canonical coordinates)."""
        ft = self.fine_tune
        h = ft["SharedMLP_0"](coords).amax(-2)
        h = torch.relu(ft["BatchNorm_0"](ft["Dense_0"](h)))
        r6 = ft["Dense_1"](h).reshape(h.shape[:-1] + (2, 3))
        r6 = r6 / torch.clamp(torch.linalg.vector_norm(r6, dim=-1, keepdim=True), min=1e-12)
        b1, a2 = r6[..., 0, :], r6[..., 1, :]
        b2 = a2 - (a2 * b1).sum(-1, keepdim=True) * b1
        b2 = b2 / torch.clamp(torch.linalg.vector_norm(b2, dim=-1, keepdim=True), min=1e-12)
        rot = torch.stack([b1, b2, torch.linalg.cross(b1, b2)], dim=-1)  # columns b1 b2 b3
        return torch.matmul(features, rot.transpose(-1, -2))

    def local_features(self, coords: torch.Tensor,
                       normals: torch.Tensor | None) -> torch.Tensor:
        """The local branch on the raw centred `coords` [b, n, 3] (and
        `normals`, which 'ppf' and 'fpfh' need) -> [b, n, fuse]."""
        with tracing.span("pvcnn.local", coords.device):
            kind = self.with_local_feat
            mlp = self.layers[self._local]
            if kind == "change_coords":
                idx = ball_query(coords, coords, self.local_radius, self.local_neighbors)
                return mlp(local_lrf(grouping(coords, idx))).amax(-2)
            if normals is None:
                raise ValueError(f"{kind!r} local features need normals: inputs [b, n, 6]")
            if kind == "fpfh":
                return mlp(fpfh(coords, normals, radius=self.local_radius))
            with_normals = torch.cat([coords, normals], -1)
            if self.training:
                # The reference's training composition: empty slots repeat the
                # first neighbour, so BatchNorm sees the duplicated rows and the
                # max runs over every slot.
                idx = ball_query(coords, coords, self.local_radius, self.local_neighbors)
                nbr = grouping(with_normals, idx)
                return mlp(local_ppf(nbr[..., :3], nbr[..., 3:], coords, normals)).amax(-2)
            nbr, slot_ok = ball_query_group(coords, coords, with_normals, self.local_radius,
                                            self.local_neighbors)
            fused = mlp(local_ppf(nbr[..., :3], nbr[..., 3:], coords, normals))
            fill = float("-inf") if fused.dtype == torch.float32 else torch.finfo(fused.dtype).min
            return fused.masked_fill(~slot_ok[..., None], fill).amax(-2)


def global_lrf_basis(coords: torch.Tensor) -> torch.Tensor:
    """The canonical frame itself: `ops.lrf.global_lrf` of coords
    [..., n, 3] -> [..., 3, 3]."""
    return global_lrf(coords)
