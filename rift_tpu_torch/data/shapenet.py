"""ShapeNet part segmentation data, a numpy copy of
`rift_tpu/data/shapenet.py` (`ShapeNetConfig`, `ShapeNet`,
`get_shapenet`) with the procedural shapes and transforms of
`synthetic_pairs.py`. The same files or synthetic split, config and seed
give the same arrays as the original.

Each item is [num_points, 3 + 3 + 16]: xyz (centred and scaled into the
unit ball when `normalize`), the normals, and the one-hot shape id last,
with per-point part labels int32 [num_points]. With `root` a directory,
the split is read from the `shapenetcore_partanno_segmentation_benchmark_
v0_normal` layout: `{root}/synsetoffset2category.txt` (one "name synset"
line per shape, its line number the shape id), the split list
`{root}/train_test_split/shuffled_{split}_file_list.json` (entries
"shape_data/<synset>/<item>") and one `{root}/<synset>/<item>.txt` per
item (rows x y z nx ny nz label); listed items whose file is missing or
empty are skipped. Otherwise the split is procedural: shapes of
`make_cloud` labelled by the octant of each point (`_synthetic_parts`).
"""
from __future__ import annotations

import json
import os
from collections.abc import Iterator
from dataclasses import dataclass, field

import numpy as np

from .synthetic_pairs import jitter, make_cloud, randchoice, random_rotation

NUM_SHAPES = 16
NUM_PART_CLASSES = 50


@dataclass(slots=True)
class ShapeNetConfig:
    root: str | None = None
    num_points: int = 2048
    with_normals: bool = True
    with_one_hot_shape_id: bool = True
    normalize: bool = True
    jitter: bool = True
    random_rot: dict = field(default_factory=lambda: {"train": True, "test": True})
    synthetic_items: dict = field(default_factory=lambda: {"train": 128, "test": 32})


def _synthetic_parts(pts: np.ndarray, shape_id: int) -> np.ndarray:
    """Pseudo-parts: the octant of each point of the centred cloud, offset
    per shape so that the 50 labels are all reached."""
    signs = (pts[:, :3] > 0).astype(np.int32)
    octant = signs[:, 0] * 4 + signs[:, 1] * 2 + signs[:, 2]
    base = (shape_id * 3) % (NUM_PART_CLASSES - 8)
    return (base + octant % 8).astype(np.int32)


class ShapeNet:
    def __init__(self, config: ShapeNetConfig, split: str):
        if split not in ("train", "test"):
            raise ValueError(f"split must be 'train' or 'test', got {split!r}")
        self.config = config
        self.split = split
        if config.root and os.path.isdir(config.root):
            self._items = self._scan_real(config.root, split)
            self._synthetic = False
        else:
            self._synthetic = True
            rs = np.random.RandomState(11 if split == "train" else 13)
            self._shape_ids = rs.randint(0, NUM_SHAPES, config.synthetic_items[split])

    @staticmethod
    def _scan_real(root: str, split: str) -> list[tuple[str, int]]:
        with open(os.path.join(root, "synsetoffset2category.txt")) as f:
            dir_to_id = {line.split()[1]: i for i, line in enumerate(f)}
        with open(os.path.join(root, "train_test_split",
                               f"shuffled_{split}_file_list.json")) as f:
            file_list = json.load(f)
        items = []
        for entry in file_list:
            _, shape_dir, filename = entry.split("/")
            path = os.path.join(root, shape_dir, filename + ".txt")
            if os.path.isfile(path) and os.path.getsize(path):
                items.append((path, dir_to_id[shape_dir]))
        return items

    def __len__(self) -> int:
        return len(self._shape_ids) if self._synthetic else len(self._items)

    def get(self, index: int, rs: np.random.RandomState) -> tuple[np.ndarray, np.ndarray]:
        """(item [num_points, c] f32, part labels [num_points] int32); the
        subsample, rotation and jitter drawn from `rs` in that order."""
        cfg = self.config
        if self._synthetic:
            shape_id = int(self._shape_ids[index])
            pcd = make_cloud(shape_id, max(cfg.num_points, 2048), seed=index + 31)
            labels = _synthetic_parts(pcd, shape_id)
        else:
            path, shape_id = self._items[index]
            data = np.loadtxt(path).astype(np.float32)
            pcd = data[:, :6]
            labels = data[:, -1].astype(np.int32)
        idx = randchoice(rs, pcd.shape[0], cfg.num_points)
        pcd, labels = pcd[idx], labels[idx]
        pts = pcd[:, :3]
        if cfg.normalize:
            pts = pts - pts.mean(0, keepdims=True)
            pts = pts / (np.max(np.linalg.norm(pts, axis=1)) + 1e-9)
        normals = pcd[:, 3:6] if cfg.with_normals else None
        if cfg.random_rot.get(self.split, False):
            if normals is not None:
                _, pts, normals = random_rotation(pts, normals, rs=rs)
            else:
                _, pts = random_rotation(pts, rs=rs)
        out = pts if normals is None else np.concatenate([pts, normals], -1)
        if cfg.jitter and self.split == "train":
            out = jitter(out, sigma=0.01, clip=0.05, rs=rs)
        if cfg.with_one_hot_shape_id:
            one_hot = np.zeros((out.shape[0], NUM_SHAPES), np.float32)
            one_hot[:, shape_id % NUM_SHAPES] = 1.0
            out = np.concatenate([out, one_hot], -1)
        return out.astype(np.float32), labels

    def batches(self, batch_size: int, seed: int = 0, shuffle: bool = True,
                drop_last: bool = True) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """(items [b, num_points, c], labels [b, num_points]) per batch, in
        a permutation drawn from RandomState(seed) when `shuffle`; every
        item's draws come from that one RandomState, in order."""
        rs = np.random.RandomState(seed)
        order = rs.permutation(len(self)) if shuffle else np.arange(len(self))
        stop = (len(order) // batch_size) * batch_size if drop_last else len(order)
        for start in range(0, stop, batch_size):
            items = [self.get(int(i), rs) for i in order[start:start + batch_size]]
            yield np.stack([c for c, _ in items]), np.stack([lbl for _, lbl in items])


def get_shapenet(config: ShapeNetConfig) -> dict[str, ShapeNet]:
    return {split: ShapeNet(config, split) for split in ("train", "test")}
