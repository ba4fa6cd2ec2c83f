"""RPM-Net-style ModelNet40 h5 registration pairs, a numpy copy of
`rift_tpu/data/mn40_hdf.py`: `Mn40HdfConfig` and `ModelNetHdf` over the
`modelnet40_ply_hdf5_2048` shards (h5 `data [m, 2048, 3|6]`, `label
[m, 1]`, optional `normal`), with the RPM-Net chains that make (src, ref,
transform_gt) pairs:

- 'clean'  — resample both sides, a random SE(3) on the reference side;
- 'jitter' — clean + clipped Gaussian noise on both sides;
- 'crop'   — jitter after independent half-space crops (partial overlap).

With `root` None the split is the synthetic stand-in of
`data/modelnet40.py:make_dataset` (2048 points, normals); a `root` that
holds no `*{split}*.h5` file raises (the reference falls back to the
stand-in). h5py is imported only to read the files. The same files or
stand-in, config and RandomState give the same arrays as the original.
"""
from __future__ import annotations

import glob
import os
from collections.abc import Iterator
from dataclasses import dataclass

import numpy as np

from .modelnet40 import make_dataset
from .synthetic_pairs import half_space_crop, jitter, randchoice, random_rotation


@dataclass
class Mn40HdfConfig:
    root: str | None = None          # directory holding *train*.h5 / *test*.h5
    num_points: int = 1024
    mode: str = "crop"               # 'clean' | 'jitter' | 'crop'
    partial_keep: float = 0.7        # RPM-Net's p_keep
    noise_sigma: float = 0.01
    noise_clip: float = 0.05
    max_degree: float = 45.0         # RPM-Net trains on mild rotations
    max_amp: float = 0.5
    synthetic_items: int = 128


MODES = ("clean", "jitter", "crop")


class ModelNetHdf:
    """One split of the h5 set, or its synthetic stand-in."""

    def __init__(self, config: Mn40HdfConfig, split: str = "test"):
        if config.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {config.mode!r}")
        self.config = config
        if config.root is None:
            seed = 7 if split == "train" else 11
            self._clouds, self._labels = make_dataset(config.synthetic_items, 2048, seed=seed,
                                                      with_normals=True)
            return
        files = sorted(glob.glob(os.path.join(config.root, f"*{split}*.h5")))
        if not files:
            raise FileNotFoundError(f"no *{split}*.h5 file under {config.root!r} "
                                    "(root=None gives the synthetic stand-in)")
        import h5py

        data, labels, normals = [], [], []
        for path in files:
            with h5py.File(path, "r") as f:
                data.append(np.asarray(f["data"], np.float32))
                labels.append(np.asarray(f["label"], np.int64).reshape(-1))
                if "normal" in f:
                    normals.append(np.asarray(f["normal"], np.float32))
        pts = np.concatenate(data)
        if normals:
            pts = np.concatenate([pts, np.concatenate(normals)], axis=-1)
        self._clouds = pts
        self._labels = np.concatenate(labels)

    def __len__(self) -> int:
        return len(self._labels)

    def get_pair(self, index: int, rs: np.random.RandomState) -> dict:
        """One registration pair under the configured chain: dict(points_src
        [n, 3], points_ref [n, 3], transform_gt [4, 4] mapping src onto ref,
        label)."""
        cfg = self.config
        cloud = self._clouds[index][:, :3]
        cloud = cloud - cloud.mean(0, keepdims=True)
        src = ref = cloud
        if cfg.mode == "crop":
            src = half_space_crop(src, cfg.partial_keep, rs)
            ref = half_space_crop(ref, cfg.partial_keep, rs)
        src = src[randchoice(rs, src.shape[0], cfg.num_points)]
        ref = ref[randchoice(rs, ref.shape[0], cfg.num_points)]
        transform, ref = random_rotation(ref, None, cfg.max_degree, cfg.max_amp, rs=rs)
        if cfg.mode in ("jitter", "crop"):
            src = jitter(src, cfg.noise_sigma, cfg.noise_clip, rs)
            ref = jitter(ref, cfg.noise_sigma, cfg.noise_clip, rs)
        return {"points_src": src.astype(np.float32),
                "points_ref": ref.astype(np.float32),
                "transform_gt": transform.astype(np.float32),
                "label": int(self._labels[index])}

    def pairs(self, seed: int = 0) -> Iterator[dict]:
        """Every item's pair in order, from one RandomState seeded `seed`."""
        rs = np.random.RandomState(seed)
        for index in range(len(self)):
            yield self.get_pair(index, rs)
