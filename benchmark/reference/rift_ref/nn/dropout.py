"""Dropout with flax's semantics and explicit draws: the units whose
uniform draw from `generator` is below 1 − rate are kept and scaled by
1/(1 − rate), the others zeroed. Under a process group (a data-parallel
step, `parallel/sharded_ops.py:global_batch`) every rank draws the global
batch's [world·b, ...] mask from the same generator state and keeps its
own rows, so that the ranks together drop what one process would."""
from __future__ import annotations

import torch
import torch.distributed as dist


def train_dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            group: dist.ProcessGroup | None = None) -> torch.Tensor:
    """x with train-mode dropout of `rate` (> 0) applied along its leading
    axis's rows."""
    if generator is None:
        raise ValueError("train-mode dropout needs a torch.Generator")
    keep = 1.0 - rate
    if group is None:
        draws = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        b = x.shape[0]
        full = torch.rand((world * b,) + tuple(x.shape[1:]), generator=generator,
                          device=x.device)
        draws = full[rank * b:(rank + 1) * b]
    return torch.where(draws < keep, x / keep, torch.zeros_like(x))
