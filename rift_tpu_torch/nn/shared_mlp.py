"""SharedMLP, twin of `rift_tpu/nn/shared_mlp.py`: per width, Linear +
BatchNorm (eps 1e-5, flax's semantics) + ReLU over the last axis of
[..., c]. In train mode BN takes its statistics over every leading axis."""
from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from .batch_norm import BatchNorm


class SharedMLP(nn.Module):
    def __init__(self, in_channels: int, widths: Sequence[int], bn_eps: float = 1e-5):
        super().__init__()
        layers = []
        for width in widths:
            layers.append(nn.ModuleDict({
                "dense": nn.Linear(in_channels, width),
                "bn": BatchNorm(width, eps=bn_eps),
            }))
            in_channels = width
        self.layers = nn.ModuleList(layers)
        self.out_channels = in_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        x = x.reshape(-1, x.shape[-1])
        for layer in self.layers:
            x = torch.relu(layer["bn"](layer["dense"](x)))
        return x.reshape(lead + (x.shape[-1],))
