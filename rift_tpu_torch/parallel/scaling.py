"""Weak scaling of registration, twin of `rift_tpu/parallel/scaling.py`:
registered pairs/s at constant work per rank as the group of ranks grows.

The pipeline (`_build_pipeline`) is the shipped preset composition:
normals of both clouds, the feature forward, mutual nearest neighbours,
then `register_pair(method="ransac+picp", noise_bound=0.02,
num_hypotheses=256)`. `registration_weak_scaling` runs it over the ranks
of the default process group (one `torchrun` launch: one card a rank with
NCCL, or CPU processes with gloo); without one it measures mesh size 1.
For each mesh size s, every rank creates the group of ranks [0, s); rank
r < s registers pairs [r·p, (r + 1)·p) of the synthetic noise pairs (p =
`pairs_per_device`) and the transforms are all-gathered, so every rank of
the group ends with all s·p of them, as the reference's replicated output.
Rank 0 times `reps` calls between two barriers of the group, after one
warm-up call; the ranks outside the group wait at a barrier of the world.

RANSAC draws from a generator seeded with the shard's first pair index
(`shard_generator`), so a rank's shard gives the same transforms whatever
the mesh size, and one process that registers each shard with its own
generator gives them too.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..ops.normals import estimate_normals
from ..ops.precision import f32_geometry
from ..registration.pipeline import register_pair
from .mesh import broadcast_object, rank_and_world

Tensor = torch.Tensor

METHOD = "ransac+picp"
NOISE_BOUND = 0.02
NUM_HYPOTHESES = 256


@dataclass
class WeakScalingResult:
    mesh_sizes: list[int] = field(default_factory=list)
    pairs_per_s: list[float] = field(default_factory=list)
    # The gathered transforms [s·p, 4, 4] (on the CPU) of the last timed
    # call at each mesh size s; not part of `as_dict`.
    transforms: dict = field(default_factory=dict, repr=False)

    @property
    def efficiency(self) -> list[float]:
        """Per-rank throughput relative to the smallest measured mesh:
        eff(N) = (tput(N)/N) / (tput(N0)/N0), tput(N)/(N·tput(1)) when mesh
        size 1 is measured."""
        if not self.pairs_per_s:
            return []
        base = self.pairs_per_s[0] / self.mesh_sizes[0]
        return [t / (n * base) for n, t in zip(self.mesh_sizes, self.pairs_per_s)]

    def as_dict(self) -> dict:
        return {"mesh_sizes": self.mesh_sizes,
                "pairs_per_s": [round(x, 3) for x in self.pairs_per_s],
                "efficiency": [round(x, 4) for x in self.efficiency]}


def default_model():
    """The reference's reduced flagship (the flagship's architecture at
    narrow widths, the reference LRF), initialized as `train.create_state`
    does from seed 0, in eval mode."""
    from ..models import PVCNNClassifier
    from ..train.steps import init_params

    model = PVCNNClassifier(
        blocks=((16, 1, 8), (32, 1, None)), dim_k=32, is_classify=False,
        point_kernel_formal="dgcnn_kernel", voxel_shape="spherical",
        rot_invariant_preprocess="change_coords", lrf_kind="reference",
        with_local_feat="ppf", extra_feature_channels=4, local_neighbors=16)
    init_params(model, 0)
    return model.eval()


def _build_pipeline(model, method: str = METHOD):
    """register_batch(src [b, n, 3], dst [b, n, 3], generator) ->
    transforms [b, 4, 4]: normals of both clouds, one forward of the eval
    `model` over them, mutual NN of the features, `register_pair` of
    `method` (RANSAC from `generator`)."""

    def register_batch(src: Tensor, dst: Tensor, generator: torch.Generator | None = None
                       ) -> Tensor:
        b = src.shape[0]
        with torch.no_grad(), f32_geometry():
            clouds = torch.cat([src, dst], 0)
            x = torch.cat([clouds, estimate_normals(clouds)], -1)
            feats = model(x)
            transform, _ = register_pair(src, dst, feats[:b], feats[b:], method=method,
                                         noise_bound=NOISE_BOUND,
                                         num_hypotheses=NUM_HYPOTHESES, generator=generator)
        return transform

    return register_batch


def weak_scaling_pairs(start: int, stop: int, num_points: int) -> tuple[np.ndarray, np.ndarray]:
    """Pairs [start, stop) of the synthetic noise pairs the harness
    registers (the reference's: `SyntheticPairs(mode="noise", max_amp=0.5)`):
    (src, dst) [stop − start, n, 3] f32."""
    from ..data import SyntheticPairs

    pairs = SyntheticPairs(num_pairs=stop, num_points=num_points, mode="noise", max_amp=0.5)
    items = [pairs[i] for i in range(start, stop)]
    return np.stack([s for s, _, _ in items]), np.stack([d for _, d, _ in items])


def shard_generator(device: torch.device, offset: int) -> torch.Generator:
    """RANSAC's generator for the shard whose first pair is `offset`, on
    `device` (with its index: each rank's card)."""
    return torch.Generator(device=device).manual_seed(offset)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def registration_weak_scaling(mesh_sizes: tuple[int, ...] = (1, 2, 4, 8),
                              pairs_per_device: int = 8, num_points: int = 256,
                              reps: int = 3, model=None,
                              device: str | torch.device | None = None) -> WeakScalingResult:
    """Registered pairs/s at each mesh size that the process group holds
    (the sizes <= its world size; size 1 alone without a group), with
    `pairs_per_device` pairs of `num_points` points a rank. `model` is an
    eval-mode feature extractor on `device` (the same weights on every
    rank), by default `default_model()`. `device=None` means the card (one
    a rank, the current device) and raises without one. Every rank returns
    rank 0's times."""
    device = resolve_device(device)
    rank, world = rank_and_world()
    if model is None:
        model = default_model().to(device)
    sizes = [s for s in mesh_sizes if s <= world]
    # Every rank creates every group of two or more ranks, in the same
    # order (new_group is collective over the world).
    groups = {s: dist.new_group(ranks=list(range(s))) for s in sizes if s > 1}
    ppd = pairs_per_device
    src_np, dst_np = weak_scaling_pairs(rank * ppd, (rank + 1) * ppd, num_points)
    src = torch.as_tensor(src_np, device=device)
    dst = torch.as_tensor(dst_np, device=device)
    register_batch = _build_pipeline(model)

    def step(size: int) -> Tensor:
        t = register_batch(src, dst, shard_generator(src.device, rank * ppd))
        if size == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t, group=groups[size])
        return torch.cat(parts, 0)

    result = WeakScalingResult()
    for size in sizes:
        seconds = None
        if rank < size:
            step(size)  # warm-up
            _sync(device)
            if size > 1:
                dist.barrier(group=groups[size])
            t0 = time.perf_counter()
            for _ in range(reps):
                out = step(size)
            _sync(device)
            if size > 1:
                dist.barrier(group=groups[size])
            seconds = (time.perf_counter() - t0) / reps
            result.transforms[size] = out.cpu()
        if world > 1:
            dist.barrier()
            seconds = broadcast_object(seconds)
        result.mesh_sizes.append(size)
        result.pairs_per_s.append(size * ppd / seconds)
    return result


__all__ = ["WeakScalingResult", "registration_weak_scaling"]
