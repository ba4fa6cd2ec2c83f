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
"""
from __future__ import annotations

import torch
from torch import nn
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.bfloat16:
            return self._normalize(x.float()).to(x.dtype)
        return self._normalize(x)

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, training=False, eps=self.eps)
        with torch.no_grad():
            dims = [d for d in range(x.dim()) if d != 1]
            var, mean = torch.var_mean(x, dim=dims, correction=0)
            self.running_mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
            self.running_var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        # Normalizes with the batch mean and the biased batch variance.
        return F.batch_norm(x, None, None, self.weight, self.bias, training=True,
                            eps=self.eps)
