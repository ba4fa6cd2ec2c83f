"""Inputs of the segmentation cell, made from the seed: part-labelled clouds of
16 procedural shape categories, in the layout of ShapeNet's part benchmark
(xyz, normals, the one-hot category last; one part label per point).

Category c is `pairs.make_cloud` of the procedural class `CLASSES[c]`,
which is built of two or three primitives (`pairs.class_structure`) and
takes ShapeNet's part range of the c-th category in synset order
(`PARTS`, 50 labels in all). A point's part is first the primitive it was
drawn from: `make_cloud` draws each primitive's points in turn, their
counts fixed from the primitives' fractions (`primitive_of_points`). While
the category has fewer parts than that, the largest part (the first on a
tie) is split at its median height in the shape's own frame, lower half
first. `make_cloud` has already centred the cloud and scaled it into the
unit ball; then a random rotation of up to 360° (no translation) turns the
points and normals, and the points are shuffled.

Each item draws from its own `RandomState` (`pairs.item_state`, stream
`STREAM`): the category, the instance's seed, the rotation and the order.
Every seed gives arrays of the same shapes.
"""
from __future__ import annotations

import numpy as np

from benchmark import pairs

# The part counts of ShapeNet's 16 categories in synset order (airplane,
# bag, cap, car, chair, earphone, guitar, knife, lamp, laptop, motorbike,
# mug, pistol, rocket, skateboard, table).
PARTS = (4, 2, 2, 4, 4, 3, 3, 2, 4, 2, 6, 2, 3, 3, 3, 3)
NUM_SHAPES = len(PARTS)
NUM_PARTS = sum(PARTS)
OFFSETS = tuple(int(x) for x in np.cumsum((0,) + PARTS[:-1]))
# make_cloud's class of each category: two-primitive classes are the even
# ones, three-primitive classes the odd ones, so a category never has more
# primitives than parts.
CLASSES = tuple(2 * c + (0 if p == 2 else 1) for c, p in enumerate(PARTS))
STREAM = 3


def primitive_of_points(label: int, num_points: int) -> np.ndarray:
    """The primitive [num_points] that each point of `make_cloud(label,
    num_points, ...)` was drawn from, by make_cloud's own counts."""
    fracs = [frac for *_, frac in pairs.class_structure(label)]
    counts = [max(int(num_points * f), 8) for f in fracs]
    counts[0] += num_points - sum(counts)
    return np.repeat(np.arange(len(counts)), counts)[:num_points]


def part_labels(points: np.ndarray, category: int) -> np.ndarray:
    """The part [n] int64 of each point of a cloud of `category` in the
    shape's own frame (before the rotation), as the module's docstring
    says."""
    n = points.shape[0]
    primitive = primitive_of_points(CLASSES[category], n)
    parts = [np.flatnonzero(primitive == j) for j in range(primitive.max() + 1)]
    while len(parts) < PARTS[category]:
        j = int(np.argmax([len(p) for p in parts]))
        order = parts[j][np.argsort(points[parts[j], 2], kind="stable")]
        half = len(order) // 2
        parts[j:j + 1] = [np.sort(order[:half]), np.sort(order[half:])]
    labels = np.empty(n, dtype=np.int64)
    for i, p in enumerate(parts):
        labels[p] = OFFSETS[category] + i
    return labels


def seg_clouds(seed: int, count: int, num_points: int = 2048, max_degree: float = 360.0
               ) -> tuple[np.ndarray, np.ndarray]:
    """`count` part-labelled clouds: [count, n, 6 + NUM_SHAPES] f32 (xyz,
    normals, the one-hot category) and labels [count, n] int64."""
    clouds = np.zeros((count, num_points, 6 + NUM_SHAPES), dtype=np.float32)
    labels = np.empty((count, num_points), dtype=np.int64)
    for index in range(count):
        rs = pairs.item_state(seed, STREAM, index)
        category = int(rs.randint(0, NUM_SHAPES))
        cloud = pairs.make_cloud(CLASSES[category], num_points, seed=int(rs.randint(0, 2 ** 31)))
        part = part_labels(cloud, category)
        _, pts, nrm = pairs.random_rotation(cloud[:, :3], cloud[:, 3:], max_degree, 0.0, rs=rs)
        order = rs.permutation(num_points)
        clouds[index, :, :3], clouds[index, :, 3:6] = pts[order], nrm[order]
        clouds[index, :, 6 + category] = 1.0
        labels[index] = part[order]
    return clouds, labels
