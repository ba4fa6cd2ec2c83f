"""Data-parallel training and sharded matching over a process group, twin
of `rift_tpu/parallel/sharded_ops.py`.

`make_sharded_train_step` is the step of the global batch split over the
ranks. The reference wraps its jitted step with batch shardings and XLA
inserts the reductions; here they are written out: under `global_batch`,
every BatchNorm normalizes with the global batch's statistics and every
dropout draws the global batch's mask (`nn/batch_norm.py`,
`nn/dropout.py`); each rank takes the backward of its rows' mean loss;
the gradients are averaged over the ranks, which with equal shards is the
gradient of the global mean loss, before the shared Adam update; and the
step's loss and accuracy are averaged too, so every rank reports the
global batch's.

`sharded_mutual_nn` is `ops.neighbors.mutual_nearest_neighbors` with the
distance matrix split by rows over the ranks.

`optimize_pose_graph_sharded` and `bundle_adjust_sharded` are the
sequence's two solves with the edges, or the landmarks, split over the
ranks: each rank assembles its shard's normal equations, (H, b) or the
Schur system (S, b) is all-reduced every iteration and solved on every
rank alike; BA's edge system is added once after the reduction, its
guard's landmark costs are all-reduced, and each rank back-substitutes
its own landmarks. On one rank both are bit-equal to the single solves
(`registration/pose_graph.py`, `registration/bundle_adjust.py`), whose
loops they share. (The reference's sharded pose graph damps its system
by 1e-6 once where its single solve adds `damping` twice; here both add
it as the single solve does.)
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from ..ops.neighbors import pairwise_sqdist
from ..ops.precision import f32_geometry
from ..registration.bundle_adjust import _edge_tensors, solve_bundle
from ..registration.pose_graph import solve_pose_graph
from ..train.steps import TrainState, apply_update, forward_backward

Tensor = torch.Tensor


def _group(group: dist.ProcessGroup | None) -> dist.ProcessGroup:
    return group if group is not None else dist.group.WORLD


def sharded_mutual_nn(feat1_tile: Tensor, feat2: Tensor,
                      group: dist.ProcessGroup | None = None
                      ) -> tuple[Tensor, Tensor, Tensor]:
    """Mutual nearest neighbours with the rows of feat1 split over the
    ranks: this rank's contiguous tile feat1_tile [r, c] (rows
    rank·r .. rank·r + r − 1 of feat1 [p·r, c]) against the whole feat2
    [n2, c]. Returns this rank's rows of `mutual_nearest_neighbors(feat1,
    feat2)`: (global row ids [r], idx2 [r], mask [r]). Each rank's column
    minima (value, global row) are all-gathered and the smallest kept, the
    lowest rank on ties, so a column's nearest row is the first minimum as
    `argmin` over the whole matrix picks it."""
    group = _group(group)
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    rows = feat1_tile.shape[0]
    d = pairwise_sqdist(feat1_tile, feat2)                  # [r, n2], this rank's tile
    corr12 = torch.argmin(d, dim=-1)
    col_min, col_arg = torch.min(d, dim=0)                  # first minimum on ties
    col_arg = col_arg + rank * rows
    all_min = [torch.empty_like(col_min) for _ in range(world)]
    all_arg = [torch.empty_like(col_arg) for _ in range(world)]
    dist.all_gather(all_min, col_min.contiguous(), group=group)
    dist.all_gather(all_arg, col_arg.contiguous(), group=group)
    winner = torch.argmin(torch.stack(all_min), dim=0)      # [n2], the lowest rank on ties
    corr21 = torch.gather(torch.stack(all_arg), 0, winner[None])[0]
    my_rows = rank * rows + torch.arange(rows, device=d.device)
    return my_rows, corr12, corr21[corr12] == my_rows


@contextlib.contextmanager
def global_batch(model: torch.nn.Module, group: dist.ProcessGroup | None = None):
    """Within the context, `model`'s BatchNorms and its dropouts see the
    global batch of `group`'s ranks (none outside it): every submodule with
    a `group` attribute (a BatchNorm, a model that draws dropout masks)
    gets it."""
    group = _group(group)
    modules = [m for m in model.modules() if hasattr(m, "group")]
    for m in modules:
        m.group = group
    try:
        yield
    finally:
        for m in modules:
            m.group = None


def average_gradients(model: torch.nn.Module, group: dist.ProcessGroup | None = None) -> None:
    """Every parameter's `.grad` replaced in place by its mean over the
    ranks (one all-reduce of all gradients)."""
    group = _group(group)
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def make_sharded_train_step(group: dist.ProcessGroup | None = None):
    """The data-parallel train step over `group` (the default group when
    None): step(state, clouds, labels, generator) with this rank's equal
    share of the global batch (`parallel.mesh.shard_batch`), every rank
    holding the same state and seeding `generator` alike; returns the
    global batch's loss and accuracy as 0-d tensors. One process drives
    one card, where the reference's one process drives every local device."""
    def step(state: TrainState, clouds: Tensor, labels: Tensor,
             generator: torch.Generator | None = None) -> dict:
        g = _group(group)
        with global_batch(state.model, g):
            loss, acc = forward_backward(state, clouds, labels, generator)
        average_gradients(state.model, g)
        apply_update(state)
        metrics = torch.stack([loss, acc])
        dist.all_reduce(metrics, group=g)
        metrics /= dist.get_world_size(g)
        return {"loss": metrics[0], "acc": metrics[1]}

    return step


def optimize_pose_graph_sharded(poses: Tensor, i_idx: Tensor, j_idx: Tensor,
                                measurements: Tensor, weights: Tensor,
                                group: dist.ProcessGroup | None = None,
                                num_iterations: int = 10, damping: float = 1e-6) -> Tensor:
    """`optimize_pose_graph` with this rank's shard of the edges (i_idx,
    j_idx, measurements, weights [E/p, ...], padded as
    `registration.sequence.pad_to_multiple` pads them: zero-weight
    self-edges of node 0) and the whole initial poses [N, 4, 4]; (H, b)
    are all-reduced over `group` every iteration. Returns the poses, the
    same on every rank."""
    with torch.no_grad(), f32_geometry():
        return solve_pose_graph(poses, i_idx.long(), j_idx.long(), measurements, weights,
                                num_iterations, damping, _group(group))


def bundle_adjust_sharded(poses: Tensor, landmarks: Tensor, obs_pose: Tensor,
                          obs_local: Tensor, group: dist.ProcessGroup | None = None,
                          num_iterations: int = 10, damping: float = 1e-4,
                          huber_delta: float | None = 0.05, edges=None
                          ) -> tuple[Tensor, Tensor]:
    """`bundle_adjust` with this rank's shard of the landmarks (landmarks,
    obs_pose, obs_local [Nl/p, ...], padded with landmarks of no
    observation) and the whole poses and `edges`, which every rank holds:
    (S, b) and the guard's landmark costs are all-reduced over `group`.
    Returns (the poses, the same on every rank; this rank's landmarks)."""
    with torch.no_grad(), f32_geometry():
        return solve_bundle(poses, landmarks, obs_pose.long(), obs_local, num_iterations,
                            damping, huber_delta, _edge_tensors(edges, poses.device),
                            _group(group))
