"""PointNet baselines, twins of `rift_tpu/models/pointnet.py`: `PointNet`
(a SharedMLP trunk, the max over the points and a SharedMLP on the cloud
feature) and `PointNetClassifier` (the small classifier with the optional
'pca' preprocess). SharedMLPs carry their flax names in `layers`, the
last Dense in `head`, so `weights.from_flax` maps a flax tree by name."""
from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from ..nn.dropout import train_dropout
from ..nn.shared_mlp import SharedMLP
from ..ops.lrf import pca_align


class PointNet(nn.Module):
    """forward(x [b, n, in_channels]) -> the cloud feature [b, cloud_features[-1]]."""

    def __init__(self, in_channels: int = 3, blocks: Sequence[int] = (64, 64, 64, 128, 1024),
                 cloud_features: Sequence[int] = (256, 128)):
        super().__init__()
        self.layers = nn.ModuleDict({
            "SharedMLP_0": SharedMLP(in_channels, list(blocks)),
            "SharedMLP_1": SharedMLP(blocks[-1], list(cloud_features))})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers["SharedMLP_1"](self.layers["SharedMLP_0"](x).amax(-2))


class PointNetClassifier(nn.Module):
    """forward(x [b, n, in_channels]) -> logits [b, num_classes]:
    (with `rot_invariant='pca'`, `pca_align` of the xyz first) SharedMLP
    `mlp`, the max over the points, SharedMLP 512, dropout 0.2 (its mask
    from `generator` in train mode), SharedMLP 256, Dense."""

    def __init__(self, in_channels: int = 3, mlp: Sequence[int] = (64, 128, 1024),
                 num_classes: int = 40, rot_invariant: str | None = None,
                 dropout: float = 0.2):
        super().__init__()
        if rot_invariant not in ("pca", None):
            raise ValueError(f"rot_invariant must be 'pca' or None, got {rot_invariant!r}")
        self.rot_invariant = rot_invariant
        self.dropout = dropout
        self.group = None  # set by parallel.sharded_ops for a data-parallel step
        width = 3 if rot_invariant == "pca" else in_channels
        self.layers = nn.ModuleDict({"SharedMLP_0": SharedMLP(width, list(mlp)),
                                     "SharedMLP_1": SharedMLP(mlp[-1], [512]),
                                     "SharedMLP_2": SharedMLP(512, [256])})
        self.head = nn.ModuleDict({"Dense_0": nn.Linear(256, num_classes)})

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None
                ) -> torch.Tensor:
        if self.rot_invariant == "pca":
            x = pca_align(x[..., :3])
        h = self.layers["SharedMLP_1"](self.layers["SharedMLP_0"](x).amax(-2))
        if self.training and self.dropout > 0.0:
            h = train_dropout(h, self.dropout, generator, self.group)
        return self.head["Dense_0"](self.layers["SharedMLP_2"](h))
