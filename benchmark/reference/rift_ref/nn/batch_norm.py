"""BatchNorm with flax's semantics, twin of `flax.linen.BatchNorm` as
`rift_tpu` uses it (`nn/shared_mlp.py`, `nn/pvconv.py`, the classifier
head of `models/pvcnn.py`).

torch's BatchNorm differs from flax's in two ways that only training shows:
its running statistics move by 0.1 of the batch's (flax: 0.01, momentum
0.99), and it keeps the *unbiased* batch variance (flax: the biased one,
E[x²] − E[x]²). Train mode here normalizes with the batch mean and biased
variance and updates running = 0.99·running + 0.01·batch; eval mode reads
the running statistics. The channel axis is 1 ([N, C] or [b, C, ...]).
The `state_dict` names are torch's: weight, bias, running_mean,
running_var. A bf16 input is normalized in f32, with the f32 statistics and
parameters, and the result is written in bf16, as flax's
`BatchNorm(dtype=bfloat16)` does.

Data-parallel training (`parallel/sharded_ops.py`) sets `group` to the
process group for the length of a step. In train mode under a group of
more than one rank the statistics are those of the global batch, as in
the reference, whose SPMD program is the single-device program: each rank
forms its rows' count n, mean and biased variance per channel, and two
differentiable all-reduces combine them (Σ n·mean with Σ n, then
Σ n·(var + (mean − global mean)²)), so the backward reaches every rank's
rows too. That is Chan's pairwise form, which keeps the digits that
E[x²] − E[x]² loses when a channel's mean is large against its spread.
A group of one rank holds the whole batch, and takes the path without a
group, bit for bit.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.nn import functional as dist_fn
from torch.nn import functional as F


class BatchNorm(nn.Module):
    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.99):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.group: dist.ProcessGroup | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.bfloat16:
            return self._normalize(x.float()).to(x.dtype)
        return self._normalize(x)

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, training=False, eps=self.eps)
        dims = [d for d in range(x.dim()) if d != 1]
        if self.group is not None and dist.get_world_size(self.group) > 1:
            return self._normalize_global(x, dims)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=dims, correction=0)
            self._update_running(mean, var)
        # Normalizes with the batch mean and the biased batch variance.
        return F.batch_norm(x, None, None, self.weight, self.bias, training=True,
                            eps=self.eps)

    def _normalize_global(self, x: torch.Tensor, dims: list[int]) -> torch.Tensor:
        var_l, mean_l = torch.var_mean(x, dim=dims, correction=0)
        n_l = x.numel() // x.shape[1]
        packed = dist_fn.all_reduce(torch.cat([mean_l * n_l, mean_l.new_full((1,), n_l)]),
                                    group=self.group)
        total = packed[-1]
        mean = packed[:-1] / total
        var = dist_fn.all_reduce(n_l * (var_l + (mean_l - mean) ** 2),
                                 group=self.group) / total
        with torch.no_grad():
            self._update_running(mean, var)
        shape = [1] * x.dim()
        shape[1] = -1
        scale = (self.weight * torch.rsqrt(var + self.eps)).reshape(shape)
        return (x - mean.reshape(shape)) * scale + self.bias.reshape(shape)

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.running_mean.mul_(self.momentum).add_(mean.detach(), alpha=1.0 - self.momentum)
        self.running_var.mul_(self.momentum).add_(var.detach(), alpha=1.0 - self.momentum)
