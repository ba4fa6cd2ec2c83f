"""Process groups for data-parallel work, twin of
`rift_tpu/parallel/mesh.py`.

The reference drives every local device from one JAX process over a
`Mesh`, and joins hosts with `jax.distributed.initialize`. Here one
process drives one card, as `torchrun` starts them (`--nproc_per_node` a
host), and the processes join one `torch.distributed` process group:
NCCL between cards, gloo between CPU processes. The reference's
`shard_batch` places each device's rows of the global batch; here each
rank keeps its own rows, and `replicate` makes every rank start from rank
0's state, as the reference's replicated sharding does.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..device import resolve_device


def initialize_multihost(device: str | torch.device | None = None
                         ) -> dist.ProcessGroup | None:
    """The default process group from torchrun's environment (`RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`): NCCL when
    `device` is the card (each rank takes card `LOCAL_RANK`), gloo when it
    is the CPU. None when `WORLD_SIZE` is unset or 1, as the reference's
    is a no-op for one process; an initialized group is returned as it is."""
    if dist.is_initialized():
        return dist.group.WORLD
    if int(os.environ.get("WORLD_SIZE", "1")) < 2:
        return None
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://")
    return dist.group.WORLD


def rank_and_world(group: dist.ProcessGroup | None = None) -> tuple[int, int]:
    """(rank, world size) in `group` (the default group when None), or
    (0, 1) without torch.distributed."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def shard_batch(arrays: tuple, group: dist.ProcessGroup | None = None) -> tuple:
    """This rank's contiguous rows of each array's leading (batch) axis:
    rows [rank·b/p, (rank + 1)·b/p) of b, for p ranks. Raises unless p
    divides b."""
    rank, world = rank_and_world(group)
    out = []
    for a in arrays:
        b = a.shape[0]
        if b % world:
            raise ValueError(f"a batch of {b} does not split over {world} ranks")
        rows = b // world
        out.append(a[rank * rows:(rank + 1) * rows])
    return tuple(out)


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def broadcast_object(obj, group: dist.ProcessGroup | None = None, src: int = 0):
    """Rank `src`'s `obj` on every rank (pickled; tensors go as CPU
    copies)."""
    payload = [_to_cpu(obj) if dist.get_rank(group) == src else None]
    dist.broadcast_object_list(payload, src=src, group=group)
    return payload[0]


def replicate(state, group: dist.ProcessGroup | None = None, src: int = 0) -> None:
    """Give every rank rank `src`'s training state in place: the model's
    parameters and buffers, the optimizer's state and the update count."""
    rank, _ = rank_and_world(group)
    saved = broadcast_object({"model": state.model.state_dict(),
                              "optimizer": state.optimizer.state_dict(),
                              "step": state.step} if rank == src else None, group, src)
    if rank != src:
        state.model.load_state_dict(saved["model"])
        state.optimizer.load_state_dict(saved["optimizer"])
        state.step = int(saved["step"])

