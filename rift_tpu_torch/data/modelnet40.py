"""ModelNet40 classification data: a numpy copy of
`rift_tpu/data/modelnet40.py` (`ModelNet40Config`, `ModelNet40`) and of
`rift_tpu/data/synthetic.py:make_dataset`, with the procedural shapes and
transforms of `synthetic_pairs.py`. The same files or synthetic split,
config and seed give the same arrays as the original.

With `root` set, the split is read from the `modelnet40_normal_resampled`
layout: `{root}/modelnet40_shape_names.txt`, the split lists
`modelnet40_{train,test}.txt` (valid reads the test list, as the
reference does) and one `{root}/{class}/{class}_XXXX.txt` per item (rows
x,y,z,nx,ny,nz). Each file is parsed once and, with `cache_npy`, kept as
`{file}.npy` beside it (written to a temporary name, then renamed, so
concurrent loaders never read half a file). `sample_method='fps'` takes
the first `num_points` of the item's furthest-point order, computed once
and kept as `{file}.fps{num_points}.npy`. A `root` that is not a
directory raises (the reference falls back to the synthetic split).
"""
from __future__ import annotations

import os
from collections.abc import Iterator
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from .synthetic_pairs import NUM_CLASSES, make_cloud, randchoice, random_rotation

SPLITS = ("train", "valid", "test")


@dataclass(slots=True)
class ModelNet40Config:
    root: str | None = None
    num_points: int = 1024
    with_normals: bool = True
    sample_method: str = "random"
    random_rot: dict = field(
        default_factory=lambda: {"train": True, "valid": True, "test": True})
    max_degree: float = 360.0
    max_amp: float = 3.0
    # host pipeline
    num_workers: int = 4           # item-loading threads (0 = serial)
    prefetch_batches: int = 4      # batches built ahead of the consumer
    cache_npy: bool = True         # one-time .npy parse cache beside each txt file
    # synthetic split sizes
    synthetic_items: dict = field(
        default_factory=lambda: {"train": 512, "valid": 128, "test": 128})
    instance_jitter: float = 0.12  # per-item shape-spec perturbation
    noise_sigma: float = 0.0       # additive Gaussian on xyz, clipped at 3σ
    occlusion: float = 0.0         # fraction removed behind a random halfspace


def make_dataset(num_items: int, num_points: int, seed: int = 0,
                 with_normals: bool = True, instance_jitter: float = 0.12
                 ) -> tuple[np.ndarray, np.ndarray]:
    """(clouds [m, n, 3|6], labels [m] int32), deterministic in `seed`."""
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, NUM_CLASSES, num_items)
    clouds = np.stack([
        make_cloud(int(lbl), num_points, seed=seed * 100003 + i,
                   with_normals=with_normals, instance_jitter=instance_jitter)
        for i, lbl in enumerate(labels)])
    return clouds, labels.astype(np.int32)


def _fps_order(points: np.ndarray, num_samples: int) -> np.ndarray:
    """Furthest-point order of `points` [n, 3] from index 0, int64
    [min(num_samples, n)]: `ops/sampling.py:furthest_point_sample` in numpy,
    as the reference computes it on the host."""
    n = points.shape[0]
    m = min(num_samples, n)
    idx = np.zeros(m, np.int64)
    min_d2 = np.full(n, np.inf, points.dtype)
    last = 0
    for k in range(m):
        idx[k] = last
        d2 = np.sum((points - points[last]) ** 2, axis=-1)
        np.minimum(min_d2, d2, out=min_d2)
        last = int(np.argmax(min_d2))
    return idx


def _save_atomic(path: str, array: np.ndarray) -> None:
    """np.save to a temporary name beside `path`, then rename over it."""
    tmp = path[:-4] + f".tmp{os.getpid()}.npy"  # np.save keeps a .npy suffix
    np.save(tmp, array)
    os.replace(tmp, path)


class ModelNet40:
    """One split of ModelNet40: the files under `config.root`, or the
    synthetic stand-in when `root` is None."""

    def __init__(self, config: ModelNet40Config, split: str):
        if split not in SPLITS:
            raise ValueError(f"unknown split {split!r}")
        if config.sample_method not in ("random", "fps"):
            raise ValueError(f"sample_method must be 'random' or 'fps', "
                             f"got {config.sample_method!r}")
        self.config = config
        self.split = split
        self._fps_cache: dict[int, np.ndarray] = {}
        self._synthetic = not config.root
        if not self._synthetic:
            if not os.path.isdir(config.root):
                raise FileNotFoundError(f"ModelNet40 root {config.root!r} is not a directory "
                                        "(root=None gives the synthetic split)")
            self._items = self._scan_real(config.root, split)
            return
        seed = {"train": 1, "valid": 2, "test": 3}[split]
        self._clouds, self._labels = make_dataset(
            config.synthetic_items[split], max(config.num_points, 2048), seed=seed,
            with_normals=True, instance_jitter=config.instance_jitter)

    @staticmethod
    def _scan_real(root: str, split: str) -> list[tuple[str, int]]:
        """(txt path, label) per item of the split list, in its order."""
        split_file = "modelnet40_train.txt" if split == "train" else "modelnet40_test.txt"
        with open(os.path.join(root, "modelnet40_shape_names.txt")) as f:
            classes = [line.strip() for line in f if line.strip()]
        class_to_idx = {c: i for i, c in enumerate(classes)}
        with open(os.path.join(root, split_file)) as f:
            names = [line.strip() for line in f if line.strip()]
        items = []
        for name in names:
            cls = "_".join(name.split("_")[:-1])
            items.append((os.path.join(root, cls, name + ".txt"), class_to_idx[cls]))
        return items

    def __len__(self) -> int:
        return len(self._labels) if self._synthetic else len(self._items)

    def _load_raw(self, index: int) -> tuple[np.ndarray, int]:
        """The full cloud [m, 6] and its label, through the .npy cache."""
        if self._synthetic:
            return self._clouds[index], int(self._labels[index])
        path, label = self._items[index]
        npy = path + ".npy"
        if self.config.cache_npy and os.path.isfile(npy):
            return np.load(npy, mmap_mode="r"), label
        pcd = np.loadtxt(path, delimiter=",").astype(np.float32)
        if self.config.cache_npy:
            _save_atomic(npy, pcd)
        return pcd, label

    def _sample_indices(self, index: int, n_avail: int,
                        rs: np.random.RandomState) -> np.ndarray:
        cfg = self.config
        if cfg.sample_method != "fps":
            return randchoice(rs, n_avail, cfg.num_points)
        order = self._fps_cache.get(index)
        if order is None:
            if self._synthetic:
                order = _fps_order(self._clouds[index][:, :3], cfg.num_points)
            else:
                fps_npy = f"{self._items[index][0]}.fps{cfg.num_points}.npy"
                if os.path.isfile(fps_npy):
                    order = np.load(fps_npy)
                else:
                    pcd, _ = self._load_raw(index)
                    order = _fps_order(np.asarray(pcd[:, :3]), cfg.num_points)
                    _save_atomic(fps_npy, order)
            self._fps_cache[index] = order
        return order[:min(cfg.num_points, n_avail)]

    def get(self, index: int, rs: np.random.RandomState | None = None,
            seed: int | None = None) -> tuple[np.ndarray, int]:
        """One item [num_points, 6|3] and its label; with a seed the
        randomness is a pure function of (seed, index)."""
        cfg = self.config
        if rs is None:
            rs = np.random.RandomState(
                (int(seed or 0) * 1_000_003 + index * 97 + 13) % (2**31 - 1))
        pcd, label = self._load_raw(index)
        if cfg.occlusion > 0.0:
            # Drop the fraction of the full cloud farthest along a random
            # direction, then sample num_points from what is left (a
            # furthest-point order indexes the uncut cloud, so random).
            full = np.asarray(pcd, np.float32)
            u = rs.randn(3)
            u /= np.linalg.norm(u) + 1e-9
            depth = full[:, :3] @ u
            pcd = full[depth <= np.quantile(depth, 1.0 - cfg.occlusion)]
            idx = randchoice(rs, pcd.shape[0], cfg.num_points)
        else:
            idx = self._sample_indices(index, pcd.shape[0], rs)
        pcd = np.asarray(pcd[idx], np.float32)
        if cfg.noise_sigma > 0.0:
            noise = rs.randn(*pcd[:, :3].shape) * cfg.noise_sigma
            pcd = pcd.copy()
            pcd[:, :3] += np.clip(noise, -3 * cfg.noise_sigma, 3 * cfg.noise_sigma)
        pts = pcd[:, :3] - pcd[:, :3].mean(0, keepdims=True)
        normals = pcd[:, 3:6] if (cfg.with_normals and pcd.shape[1] >= 6) else None
        if cfg.random_rot.get(self.split, False):
            if normals is not None:
                _, pts, normals = random_rotation(pts, normals, cfg.max_degree,
                                                  cfg.max_amp, rs=rs)
            else:
                _, pts = random_rotation(pts, None, cfg.max_degree, cfg.max_amp, rs=rs)
        out = np.concatenate([pts, normals], -1) if normals is not None else pts
        return out.astype(np.float32), label

    def batches(self, batch_size: int, seed: int = 0, shuffle: bool = True,
                drop_last: bool = True) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Yield (clouds [b, n, c], labels [b] int32); items load on a thread
        pool with `prefetch_batches` batches built ahead of the consumer."""
        rs = np.random.RandomState(seed)
        order = rs.permutation(len(self)) if shuffle else np.arange(len(self))
        stop = (len(order) // batch_size) * batch_size if drop_last else len(order)
        starts = list(range(0, stop, batch_size))

        def build(start: int) -> tuple[np.ndarray, np.ndarray]:
            chunk = order[start:start + batch_size]
            items = [self.get(int(i), seed=seed * 131 + start + k)
                     for k, i in enumerate(chunk)]
            return (np.stack([c for c, _ in items]),
                    np.asarray([label for _, label in items], np.int32))

        if self.config.num_workers <= 0 or len(starts) <= 1:
            for start in starts:
                yield build(start)
            return
        with ThreadPoolExecutor(self.config.num_workers) as pool:
            depth = max(self.config.prefetch_batches, 1)
            pending = [pool.submit(build, s) for s in starts[:depth]]
            next_submit = depth
            for _ in starts:
                fut = pending.pop(0)
                if next_submit < len(starts):
                    pending.append(pool.submit(build, starts[next_submit]))
                    next_submit += 1
                yield fut.result()


def get_datasets(config: ModelNet40Config) -> dict[str, ModelNet40]:
    return {split: ModelNet40(config, split) for split in SPLITS}
