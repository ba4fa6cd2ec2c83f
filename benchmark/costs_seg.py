"""Frozen operation counts of the segmentation model (`ShapeNetPVCNN`), from
`costs.py`'s stages: the trunk of `costs.trunk_costs` (the local-PPF
branch, the dgcnn PVConv blocks and the SharedMLP blocks, on 7 + 64 input
channels: the LRF coordinates, the 4 global-PPF channels and the local
branch) and the per-point head, each of its layers a one-layer SharedMLP
over every point: the concatenation of the one-hot id, every block's output
and the global max -> 256 -> 256 -> 128 -> the part classes. BatchNorm,
dropout and the max-pools are left out, as `costs.py` leaves them out.
"""
from __future__ import annotations

from benchmark import costs


def head_costs(model: dict, clouds: int, n: int) -> list[costs.StageCost]:
    """The per-point head's layers on `clouds` clouds of n points."""
    widths = [w for w, _, _ in model["blocks"]]
    cin = model["num_shapes"] + sum(widths) + widths[-1]
    out = []
    for cout in (*model["head"], model["num_classes"]):
        out.append(costs.cost_shared_mlp(clouds, n, cin, cout, model.get("dtype")))
        cin = cout
    return out


def seg_costs(model: dict, clouds: int, n: int) -> list[costs.StageCost]:
    """The forward's stages: the trunk, then the head."""
    trunk = dict(model, extra_feature_channels=4 if model["global_ppf"] else 0)
    return [*costs.trunk_costs(trunk, clouds, n), *head_costs(model, clouds, n)]


def forward_flops(model: dict, clouds: int, n: int) -> float:
    return float(sum(s.flops for s in seg_costs(model, clouds, n)))


def train_flops(model: dict, clouds: int, n: int) -> float:
    """A training step as 3 × its forward."""
    return 3.0 * forward_flops(model, clouds, n)
