"""ModelNet40 with a 4-way PCA-reflection label, a numpy copy of
`rift_tpu/data/modelnet40_4class.py`: each rotated item carries, beside
its class, a label in {0, 1, 2, 3} saying which of the first two
principal axes changed sign between the cloud's PCA basis and the rotated
cloud's (the reflection ambiguity of SVD alignment, which the PCA
baseline `models.PointNetClassifier` meets). The same config, split and
RandomState give the same arrays as the original.
"""
from __future__ import annotations

import copy

import numpy as np

from .modelnet40 import ModelNet40, ModelNet40Config
from .synthetic_pairs import random_rotation


def reflection_label(source: np.ndarray, target: np.ndarray, rotation: np.ndarray) -> int:
    """The label of source [n, 3] and target = source @ Rᵀ + t [n, 3] under
    rotation R [3, 3]: with su, tu the principal axes (SVD) of the centred
    clouds, s_j = sign((Rᵀ·tu / su)[0, j]) for j = 0, 1, and the label is
    2·(1 − s_0)/2 + (1 − s_1)/2."""
    s = source - source.mean(0, keepdims=True)
    t = target - target.mean(0, keepdims=True)
    su, _, _ = np.linalg.svd(s.T @ s)
    tu, _, _ = np.linalg.svd(t.T @ t)
    ratio = rotation[:3, :3].T @ tu / np.where(np.abs(su) < 1e-12, 1e-12, su)
    signs = (1 - np.sign(ratio[0, :2])) / 2
    return int(signs[0] * 2 + signs[1])


class ModelNet40FourClass(ModelNet40):
    """ModelNet40 whose items are (cloud, (class label, reflection label)).

    The split's own rotation is turned off; each item is rotated here,
    after the unrotated sample is drawn, so that the label can compare
    the PCA bases before and after the rotation. `batches` yields labels
    [b, 2] (class, reflection), which `train.meters.MeterReflection`
    reads."""

    def __init__(self, config: ModelNet40Config, split: str):
        config = copy.deepcopy(config)
        config.random_rot = {s: False for s in config.random_rot}
        super().__init__(config, split)

    def get(self, index: int, rs: np.random.RandomState | None = None,
            seed: int | None = None):
        if rs is None:  # the base class's RandomState of (seed, index)
            rs = np.random.RandomState(
                (int(seed or 0) * 1_000_003 + index * 97 + 13) % (2**31 - 1))
        cloud, label = super().get(index, rs)
        points = cloud[:, :3]
        normals = cloud[:, 3:] if cloud.shape[1] > 3 else None
        if normals is not None:
            trans, target, target_normals = random_rotation(points, normals, rs=rs)
            out = np.concatenate([target, target_normals], axis=1)
        else:
            trans, target = random_rotation(points, rs=rs)
            out = target
        four = reflection_label(points, target, trans[:3, :3])
        return out.astype(np.float32), (label, four)
