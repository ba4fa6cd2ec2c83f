"""The plain reference that decides `correct`.

`rift_ref/` is a frozen copy of the port's plain PyTorch paths: the PVCNN
model and its blocks, the geometry (normals, LRF, PPF, neighbours, voxel
grids), the robust solvers (GNC-TLS, TEASER's core) and the consensus
matching, with each hand-written kernel replaced by its plain version
(`rift_ref/ops/plain/`). It imports nothing of the program and nothing of
JAX, and works out again from the benchmark's inputs and weights
everything that the program derived from them. `ops/precision.py` holds
the switch of the controls: the reference computed one step below the
configuration's precision.

The functions here run the reference's side of each driver's comparison,
in blocks of clouds so that it fits beside what the run holds.
"""
from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from .rift_ref.models.pvcnn import PVCNNClassifier
from .rift_ref.ops.lrf import lrf_basis, lrf_flip_hypotheses
from .rift_ref.ops.neighbors import gather_rows, mutual_nearest_neighbors
from .rift_ref.ops.normals import estimate_normals
from .rift_ref.ops.precision import f32_geometry, lower_precision
from .rift_ref.registration.consensus import consensus_match
from .rift_ref.registration.gnc import gnc_pose, teaser_pose

__all__ = ["PVCNNClassifier", "lower_precision", "normals", "features", "flip_features",
           "register_from_features", "teaser_from_features", "register_batch",
           "register_eval_batch", "TrainReference"]

BLOCK = 32  # clouds a block of the reference's forward


def normals(clouds: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """estimate_normals of clouds [B, n, 3], a block of clouds at a time."""
    with torch.no_grad(), f32_geometry():
        return torch.cat([estimate_normals(clouds[i:i + block])
                          for i in range(0, clouds.shape[0], block)])


def features(model: PVCNNClassifier, x: torch.Tensor, lrf: torch.Tensor | None = None,
             block: int = BLOCK) -> torch.Tensor:
    """The eval model's features of x [B, n, 6] (with the bases `lrf`
    [B, 3, 3] when given), a block of clouds at a time."""
    out = []
    with torch.no_grad(), f32_geometry():
        for i in range(0, x.shape[0], block):
            out.append(model(x[i:i + block], lrf=None if lrf is None else lrf[i:i + block]))
    return torch.cat(out)


def flip_bases(clouds: torch.Tensor, b: int, lrf_kind: str) -> torch.Tensor:
    """The bases of the flip forward for clouds [2b, n, 3]: each source's 4
    sign flips of its LRF, in sources' order, then each target's own."""
    with torch.no_grad(), f32_geometry():
        basis = lrf_basis(clouds - clouds.mean(-2, keepdim=True), lrf_kind)
        return torch.cat([lrf_flip_hypotheses(basis[:b]).reshape(-1, 3, 3), basis[b:]], 0)


def flip_features(model: PVCNNClassifier, x: torch.Tensor, b: int,
                  block: int = BLOCK) -> torch.Tensor:
    """Features [5b, n, c] of x [2b, n, 6]: each source under its 4 LRF
    flips, then each target, as the flagship evaluation's one forward."""
    lrf = flip_bases(x[..., :3].contiguous(), b, model.lrf_kind)
    return features(model, torch.cat([x[:b].repeat_interleave(4, dim=0), x[b:]], 0), lrf,
                    block)


def register_from_features(src: torch.Tensor, dst: torch.Tensor, feats: torch.Tensor,
                           noise_bound: float, early_exit: bool) -> torch.Tensor:
    """Mutual-NN matches of feats [2b, n, c] (sources, then targets) and
    GNC-TLS: transforms [b, 4, 4]."""
    b = src.shape[0]
    with torch.no_grad(), f32_geometry():
        _, idx2, mask = mutual_nearest_neighbors(feats[:b], feats[b:])
        matched = torch.gather(dst, 1, idx2[..., None].expand(-1, -1, 3))
        return gnc_pose(src, matched, mask, noise_bound=noise_bound, early_exit=early_exit)[0]


def teaser_from_features(src: torch.Tensor, dst: torch.Tensor, feats: torch.Tensor,
                         noise_bound: float) -> torch.Tensor:
    """The flagship evaluation's solve from the flip forward's feats [5b, n,
    c]: `consensus_match` at tau = 2·noise_bound, then TEASER's core on the
    chosen matches: transforms [b, 4, 4]."""
    b, n = src.shape[:2]
    with torch.no_grad(), f32_geometry():
        i1, i2, mask, _ = consensus_match(src, dst, feats[:4 * b].reshape(b, 4, n, -1),
                                          feats[4 * b:], tau=2.0 * noise_bound)
        return teaser_pose(gather_rows(src, i1), gather_rows(dst, i2), mask,
                           noise_bound=noise_bound)[0]


def register_batch(model: PVCNNClassifier, src: torch.Tensor, dst: torch.Tensor,
                   noise_bound: float, early_exit: bool) -> torch.Tensor:
    """The whole registration of the reference, `register_batch`'s
    counterpart: normals, features, matches, GNC-TLS."""
    clouds = torch.cat([src, dst], 0)
    feats = features(model, torch.cat([clouds, normals(clouds)], -1))
    return register_from_features(src, dst, feats, noise_bound, early_exit)


def register_eval_batch(model: PVCNNClassifier, src: torch.Tensor, dst: torch.Tensor,
                        noise_bound: float) -> torch.Tensor:
    """The flagship evaluation of the reference, `register_eval_batch`'s
    counterpart with flips and TEASER."""
    clouds = torch.cat([src, dst], 0)
    feats = flip_features(model, torch.cat([clouds, normals(clouds)], -1), src.shape[0])
    return teaser_from_features(src, dst, feats, noise_bound)


class TrainReference:
    """The reference's training step: the classifier in train mode, the mean
    cross-entropy, torch's Adam with L2-in-gradient weight decay at β =
    (0.9, 0.999), eps 1e-8, and the cosine rate of the configuration's
    `optim` block; dropout masks from `generator`."""

    def __init__(self, model: PVCNNClassifier, optim: dict, steps_per_epoch: int):
        self.model = model
        self.optim = optim
        self.total = max(optim["num_epochs"] * steps_per_epoch, 1)
        self.opt = torch.optim.Adam(model.parameters(), lr=optim["lr"], betas=(0.9, 0.999),
                                    eps=1e-8, weight_decay=optim.get("weight_decay") or 0.0)
        self.t = 0

    def rate(self, t: int) -> float:
        lr = self.optim["lr"]
        if self.optim.get("schedule") != "cosine":
            return lr
        return lr * 0.5 * (1.0 + math.cos(math.pi * min(t, self.total) / self.total))

    def step(self, clouds: torch.Tensor, labels: torch.Tensor,
             generator: torch.Generator | None) -> torch.Tensor:
        """One update; returns the loss (0-d)."""
        self.model.train()
        with f32_geometry():
            logits = self.model(clouds, generator=generator)
            loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))
            self.opt.zero_grad(set_to_none=True)
            loss.backward()
        for group in self.opt.param_groups:
            group["lr"] = self.rate(self.t)
        self.opt.step()
        self.t += 1
        return loss.detach()
