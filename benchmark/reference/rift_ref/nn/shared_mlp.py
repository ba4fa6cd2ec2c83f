"""SharedMLP, twin of `rift_tpu/nn/shared_mlp.py`: per width, Linear +
BatchNorm (eps 1e-5, flax's semantics) + ReLU over the last axis of
[..., c]. In train mode BN takes its statistics over every leading axis.

With `dtype` (bf16 in the bench model) the layers compute as flax's
`Dense(dtype=...)` and `BatchNorm(dtype=...)` do: parameters stay f32; the
input, kernel and bias are cast to `dtype`, the bias is added to the
rounded product; BatchNorm normalizes in f32 and writes `dtype`."""
from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.precision import low
from .batch_norm import BatchNorm


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """`layer(x)`, or flax's `Dense(dtype=dtype)` on the same parameters:
    input, kernel and bias cast to `dtype`, the bias added after the
    product is rounded. Under the fp8 control both operands are rounded
    to fp8 first (`ops/precision.py:low`)."""
    if dtype is None:
        return layer(x)
    y = F.linear(low(x.to(dtype)), low(layer.weight.to(dtype)))
    return y if layer.bias is None else y + layer.bias.to(dtype)


class SharedMLP(nn.Module):
    def __init__(self, in_channels: int, widths: Sequence[int], bn_eps: float = 1e-5,
                 dtype: torch.dtype | None = None):
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
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        x = x.reshape(-1, x.shape[-1])
        for layer in self.layers:
            x = torch.relu(layer["bn"](dense(layer["dense"], x, self.dtype)))
        return x.reshape(lead + (x.shape[-1],))
