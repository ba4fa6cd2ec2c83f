"""ModelNet40 classification data, synthetic split only: a numpy copy of
`rift_tpu/data/modelnet40.py` (`ModelNet40Config`, `ModelNet40`) and of
`rift_tpu/data/synthetic.py:make_dataset`, with the procedural shapes and
transforms of `synthetic_pairs.py`. The same config, split and seed give
the same arrays as the original.

Not ported yet: the real-file loader (`root` set) and furthest-point
sampling (`sample_method='fps'`); both raise.
"""
from __future__ import annotations

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


class ModelNet40:
    """One split of the synthetic ModelNet40 stand-in."""

    def __init__(self, config: ModelNet40Config, split: str):
        if split not in SPLITS:
            raise ValueError(f"unknown split {split!r}")
        if config.root:
            raise NotImplementedError("the ModelNet40 file loader is not ported yet; "
                                      "root=None gives the synthetic split")
        if config.sample_method != "random":
            raise NotImplementedError(f"sample_method {config.sample_method!r} "
                                      "is not ported yet")
        self.config = config
        self.split = split
        seed = {"train": 1, "valid": 2, "test": 3}[split]
        self._clouds, self._labels = make_dataset(
            config.synthetic_items[split], max(config.num_points, 2048), seed=seed,
            with_normals=True, instance_jitter=config.instance_jitter)

    def __len__(self) -> int:
        return len(self._labels)

    def get(self, index: int, rs: np.random.RandomState | None = None,
            seed: int | None = None) -> tuple[np.ndarray, int]:
        """One item [num_points, 6|3] and its label; with a seed the
        randomness is a pure function of (seed, index)."""
        cfg = self.config
        if rs is None:
            rs = np.random.RandomState(
                (int(seed or 0) * 1_000_003 + index * 97 + 13) % (2**31 - 1))
        pcd, label = self._clouds[index], int(self._labels[index])
        if cfg.occlusion > 0.0:
            # Drop the fraction of the full cloud farthest along a random
            # direction, then sample num_points from what is left.
            u = rs.randn(3)
            u /= np.linalg.norm(u) + 1e-9
            depth = pcd[:, :3] @ u
            pcd = pcd[depth <= np.quantile(depth, 1.0 - cfg.occlusion)]
        pcd = np.asarray(pcd[randchoice(rs, pcd.shape[0], cfg.num_points)], np.float32)
        if cfg.noise_sigma > 0.0:
            noise = rs.randn(*pcd[:, :3].shape) * cfg.noise_sigma
            pcd = pcd.copy()
            pcd[:, :3] += np.clip(noise, -3 * cfg.noise_sigma, 3 * cfg.noise_sigma)
        pts = pcd[:, :3] - pcd[:, :3].mean(0, keepdims=True)
        normals = pcd[:, 3:6] if cfg.with_normals else None
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
