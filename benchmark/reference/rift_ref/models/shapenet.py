"""ShapeNet part segmentation PVCNN in plain torch, the reference of the
segmentation cell: a frozen copy of the port's `models/shapenet.py:
ShapeNetPVCNN` built from this package's blocks (`PVConv`, `SharedMLP`,
`change_coords`, `global_ppf`, `ball_query`, `grouping`, `local_ppf`,
`train_dropout`), with the kernels' plain versions under them.

Input [b, n, in_channels + num_shapes]: xyz, the normals when
`in_channels` >= 6, and the one-hot shape id in the last `num_shapes`
channels. 'change_coords' puts the centred cloud in the reference LRF and
appends the global PPF of the raw coordinates when there are normals (7
channels); with `with_local_feat`, each point's `ball_query`
neighbourhood (radius 0.3, `local_neighbors` slots, empty slots repeating
the first neighbour) gives the local PPF, through SharedMLP[32, 64] and a
max over the slots. The backbone's PVConv blocks voxelize the raw
coordinates. The one-hot id, every block's output and the last block's
max over the points (broadcast) are concatenated (1488 channels at the
default widths) and classified per point by SharedMLP 256 -> dropout 0.2
-> SharedMLP 256 -> dropout 0.2 -> SharedMLP 128 -> Linear num_classes.
The state dict's names are the port's, so one seeded state loads into
both. Run it inside `ops/precision.py:f32_geometry` on a card (TF32 off),
as `TrainReference.step` does.

Departures from upstream's `PVCNN/models/shapenet_pvcnn.py:
shapenet_PVCNN`, all of them the JAX twin's (`rift_tpu/models/
shapenet.py`) and the port's:
- channels-last [b, n, c] at every boundary, where upstream runs
  channels-first [b, c, n];
- BatchNorm with flax's semantics (`nn/batch_norm.py`: running statistics
  moved by 0.01 with the biased batch variance), where upstream's torch
  BatchNorm moves them by 0.1 with the unbiased one;
- dropout with flax's rule (keep a unit whose uniform draw is below
  1 − rate) from an explicit generator (`nn/dropout.py`);
- the 'change_coords' frame is the reference LRF alone (no `lrf_kind`),
  and `extra_feature_channels` is not a field: the global PPF follows
  from the normals;
- the local-PPF branch is the classifier's (`models/pvcnn.py`'s
  training composition), inline;
- PVConv without SE and without the coefficient, the cube grid's
  `normalize=False`, and the dgcnn point branch's edge against the mean
  of the point's own voxel (`nn/pvconv.py`);
- the weights come from flax's initializers (`benchmark/weights.py`), not
  torch's defaults.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from ..nn.dropout import train_dropout
from ..nn.pvconv import PVConv
from ..nn.shared_mlp import SharedMLP
from ..ops.lrf import change_coords
from ..ops.neighbors import ball_query, grouping
from ..ops.ppf import global_ppf, local_ppf
from .pvcnn import INVARIANT_CHANNELS, PREPROCESSES, invariant_features

DEFAULT_SEG_BLOCKS = ((64, 1, 32), (128, 1, 32), (256, 1, None), (512, 1, None))
HEAD_WIDTHS = (256, 256, 128)  # dropout after each but the last


class ShapeNetPVCNN(nn.Module):
    """The port's fields and defaults; `in_channels` is the inputs' width
    before the one-hot id."""

    def __init__(self, blocks: Sequence[tuple[int, int, int | None]] = DEFAULT_SEG_BLOCKS,
                 num_classes: int = 50, num_shapes: int = 16,
                 point_kernel_formal: str = "dgcnn_kernel",
                 voxel_shape: str = "spherical",
                 width_multiplier: float = 1.0,
                 voxel_resolution_multiplier: float = 1.0,
                 rot_invariant_preprocess: str | None = "change_coords",
                 with_local_feat: bool = False,
                 local_radius: float = 0.3, local_neighbors: int = 128,
                 local_fuse_dim: int = 64,
                 in_channels: int = 6,
                 dropout: float = 0.2):
        super().__init__()
        if rot_invariant_preprocess not in PREPROCESSES:
            raise ValueError(f"unknown rot_invariant_preprocess {rot_invariant_preprocess!r}")
        self.rot_invariant_preprocess = rot_invariant_preprocess
        self.num_shapes = num_shapes
        self.in_channels = in_channels
        self.with_normals = in_channels >= 6
        self.local_radius = local_radius
        self.local_neighbors = local_neighbors
        self.dropout = dropout
        if rot_invariant_preprocess == "change_coords":
            in_ch = 7 if self.with_normals else 3
        else:
            in_ch = INVARIANT_CHANNELS.get(rot_invariant_preprocess, in_channels)
        layers = {}
        n_mlp = 0
        self._local = None
        if with_local_feat:
            if not self.with_normals:
                raise ValueError("the local PPF needs normals: in_channels >= 6")
            self._local = "SharedMLP_0"
            layers[self._local] = SharedMLP(4, [32, local_fuse_dim])
            n_mlp += 1
            in_ch += local_fuse_dim
        self._backbone: list[list[str]] = []
        concat = num_shapes
        n_pv = 0
        for out_ch, num_blocks, resolution in blocks:
            out_ch = int(out_ch * width_multiplier)
            self._backbone.append([])
            for _ in range(num_blocks):
                if resolution is None:
                    name = f"SharedMLP_{n_mlp}"
                    layers[name] = SharedMLP(in_ch, [out_ch])
                    n_mlp += 1
                else:
                    name = f"PVConv_{n_pv}"
                    layers[name] = PVConv(
                        in_ch, out_ch, point_kernel_formal=point_kernel_formal,
                        voxel_shape=voxel_shape,
                        resolution=int(resolution * voxel_resolution_multiplier),
                        with_coeff=False, with_se=False, normalize=False)
                    n_pv += 1
                self._backbone[-1].append(name)
                in_ch = out_ch
            concat += in_ch
        concat += in_ch  # the global max
        self._head: list[str] = []
        for width in HEAD_WIDTHS:
            name = f"SharedMLP_{n_mlp}"
            layers[name] = SharedMLP(concat, [int(width * width_multiplier)])
            n_mlp += 1
            concat = int(width * width_multiplier)
            self._head.append(name)
        self.layers = nn.ModuleDict(layers)
        self.head = nn.ModuleDict({"Dense_0": nn.Linear(concat, num_classes)})

    def forward(self, inputs: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """inputs [b, n, in_channels + num_shapes] -> logits [b, n, num_classes]."""
        if inputs.shape[-1] != self.in_channels + self.num_shapes:
            raise ValueError(f"inputs have {inputs.shape[-1]} channels, the model "
                             f"{self.in_channels} + {self.num_shapes}")
        one_hot = inputs[..., -self.num_shapes:]
        coords = inputs[..., :3]
        normals = inputs[..., 3:6] if self.with_normals else None
        mode = self.rot_invariant_preprocess
        if mode == "change_coords":
            features = change_coords(coords - coords.mean(-2, keepdim=True))
            if normals is not None:
                features = torch.cat([features, global_ppf(coords, normals)], dim=-1)
        elif mode is None:
            features = inputs[..., :self.in_channels]
        else:
            features = invariant_features(mode, coords, normals)
        if self._local is not None:
            idx = ball_query(coords, coords, self.local_radius, self.local_neighbors)
            nbr = grouping(torch.cat([coords, normals], -1), idx)
            fused = self.layers[self._local](local_ppf(nbr[..., :3], nbr[..., 3:], coords,
                                                       normals))
            features = torch.cat([features, fused.amax(-2)], dim=-1)
        out = [one_hot]
        for names in self._backbone:
            for name in names:
                layer = self.layers[name]
                features = (layer(features, coords) if isinstance(layer, PVConv)
                            else layer(features))
            out.append(features)
        out.append(features.amax(-2, keepdim=True).expand(features.shape))
        x = torch.cat(out, dim=-1)
        for name in self._head:
            x = self.layers[name](x)
            if name != self._head[-1] and self.training and self.dropout > 0.0:
                x = train_dropout(x, self.dropout, generator)
        return self.head["Dense_0"](x)
