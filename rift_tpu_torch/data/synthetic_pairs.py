"""Registration pairs, a numpy copy of `rift_tpu.data.registration_pairs`:
`PairBatch`; `SyntheticPairs` in its 'clean', 'noise', 'partial' and
'partialK' modes; `SequencePairs`, the adjacent scans of the synthetic
indoor trajectory (the 'icl_nuim' mode, `data/sequences.py`);
`H5TestPairs`, the DeepGMR-format h5 test files (needs h5py); and
`get_pairs`. With them, the procedural shapes of
`rift_tpu/data/synthetic.py` and the transforms and crops of
`rift_tpu/data/transforms.py` (`half_space_crop` and `resample` for
`data/mn40_hdf.py`). The same seed or file gives the
same arrays as the original.
"""
from __future__ import annotations

import os
from collections.abc import Iterator
from dataclasses import dataclass

import numpy as np

NUM_CLASSES = 40


def _sphere(u, v, p):
    r = p[0]
    x = r * np.sin(v) * np.cos(u)
    y = r * np.sin(v) * np.sin(u)
    z = r * np.cos(v)
    pts = np.stack([x, y, z], -1)
    n = pts / np.maximum(np.linalg.norm(pts, axis=-1, keepdims=True), 1e-9)
    return pts, n


def _superellipsoid_pts(u, v, p):
    a, b, c, e1, e2 = p[:5]

    def f(w, m):
        return np.sign(w) * np.abs(w) ** m

    x = a * f(np.sin(v), e1) * f(np.cos(u), e2)
    y = b * f(np.sin(v), e1) * f(np.sin(u), e2)
    z = c * f(np.cos(v), e1)
    return np.stack([x, y, z], -1)


def _superellipsoid(u, v, p):
    pts = _superellipsoid_pts(u, v, p)
    # numeric normals via finite-difference tangents
    eps = 1e-3
    du = _superellipsoid_pts(u + eps, v, p) - pts
    dv = _superellipsoid_pts(u, v + eps, p) - pts
    n = np.cross(du, dv)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    return pts, n


def _torus(u, v, p):
    cr, tr = p[0], p[1] * 0.4
    x = (cr + tr * np.cos(v)) * np.cos(u)
    y = (cr + tr * np.cos(v)) * np.sin(u)
    z = tr * np.sin(v)
    pts = np.stack([x, y, z], -1)
    center = np.stack([cr * np.cos(u), cr * np.sin(u), np.zeros_like(u)], -1)
    n = pts - center
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    return pts, n


def _cone(u, v, p):
    h, r = p[0], p[1]
    t = (v / np.pi)  # 0..1 along height
    x = r * (1 - t) * np.cos(u)
    y = r * (1 - t) * np.sin(u)
    z = h * (t - 0.5)
    pts = np.stack([x, y, z], -1)
    slope = np.stack([np.cos(u), np.sin(u), np.full_like(u, r / h)], -1)
    n = slope / np.maximum(np.linalg.norm(slope, axis=-1, keepdims=True), 1e-9)
    return pts, n


def _capsule(u, v, p):
    r, h = p[0] * 0.5, p[1]
    z = np.where(v < np.pi / 2, h / 2 + r * np.cos(v),
                 np.where(v > np.pi / 2, -h / 2 + r * np.cos(v), 0.0))
    rad = r * np.sin(v)
    x = rad * np.cos(u)
    y = rad * np.sin(u)
    pts = np.stack([x, y, z], -1)
    axis_pt = np.stack([np.zeros_like(u), np.zeros_like(u),
                        np.clip(z, -h / 2, h / 2)], -1)
    n = pts - axis_pt
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    return pts, n


_FAMILIES = [_sphere, _superellipsoid, _torus, _cone, _capsule]


def class_params(label: int) -> np.ndarray:
    """Deterministic shape parameters for a pseudo-class id."""
    rs = np.random.RandomState(1000 + label)
    return rs.uniform(0.4, 1.0, size=5)


def class_structure(label: int) -> list[tuple[int, np.ndarray, float,
                                              np.ndarray, float]]:
    """Deterministic composite spec for a class: [(family, params, scale,
    offset, point_fraction)].

    Classes are ASYMMETRIC composites (a primary primitive plus 1-2 smaller
    primitives at off-center offsets) — like real ModelNet40 objects
    (airplanes, chairs), and unlike single superellipsoids/tori, they are
    not point-symmetric, so a global reference frame is well-defined. A
    symmetric corpus makes two-stage registration intrinsically ambiguous
    (every global-LRF method flips on resampled symmetric shapes)."""
    rs = np.random.RandomState(5000 + label)
    n_parts = 2 + (label % 2)
    fracs = ([0.6, 0.4] if n_parts == 2 else [0.5, 0.3, 0.2])
    scales = [1.0, 0.45, 0.3]
    specs = []
    for j in range(n_parts):
        fam = int(rs.randint(0, len(_FAMILIES)))
        params = rs.uniform(0.4, 1.0, 5)
        if j == 0:
            offset = np.zeros(3)
        else:
            offset = rs.uniform(-0.5, 0.5, 3)
            offset += np.sign(offset + 1e-9) * 0.35  # keep it off-center
        specs.append((fam, params, scales[j], offset, fracs[j]))
    return specs


def make_cloud(label: int, num_points: int, seed: int,
               with_normals: bool = True,
               instance_jitter: float = 0.12) -> np.ndarray:
    """One cloud of class `label`: [n, 6] (xyz + unit normal) or [n, 3].

    `instance_jitter` perturbs the class's composite spec per item (part
    parameters, scales, offsets, anisotropy) — real ModelNet40 classes
    contain distinct mesh instances, not resamplings of one surface, and
    without within-class variation the classification task saturates
    trivially. Jitter is deterministic in `seed`, small relative to the
    inter-class parameter spread (classes draw params from U(0.4, 1.0))."""
    rs = np.random.RandomState(seed)
    aniso = 0.5 + 0.5 * (class_params(label * 7 + 3)[:3])
    aniso = aniso * (1.0 + instance_jitter * rs.uniform(-1, 1, 3))
    specs = [
        (fam, params * (1.0 + instance_jitter * rs.uniform(-1, 1, 5)),
         scale * (1.0 + instance_jitter * rs.uniform(-1, 1)),
         offset + (instance_jitter * 0.5) * rs.uniform(-1, 1, 3)
         if j > 0 else offset,
         frac)
        for j, (fam, params, scale, offset, frac)
        in enumerate(class_structure(label))
    ]
    counts = [max(int(num_points * frac), 8) for *_, frac in specs]
    counts[0] += num_points - sum(counts)
    pts_parts, nrm_parts = [], []
    for (fam_idx, params, scale, offset, _), n_j in zip(specs, counts):
        fam = _FAMILIES[fam_idx % len(_FAMILIES)]
        u = rs.uniform(0, 2 * np.pi, n_j)
        v = rs.uniform(1e-3, np.pi - 1e-3, n_j)
        pts, n = fam(u, v, params)
        pts = pts * aniso * scale + offset
        n = n / aniso
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
        pts_parts.append(pts)
        nrm_parts.append(n)
    pts = np.concatenate(pts_parts, 0)[:num_points]
    n = np.concatenate(nrm_parts, 0)[:num_points]
    pts = pts - pts.mean(0, keepdims=True)
    pts /= np.max(np.linalg.norm(pts, axis=-1)) + 1e-9
    out = np.concatenate([pts, n], axis=-1) if with_normals else pts
    return out.astype(np.float32)


def random_rotation(points: np.ndarray, normals: np.ndarray | None = None,
                    max_degree: float = 360.0, max_amp: float = 3.0,
                    rs: np.random.RandomState | None = None):
    """Random SE(3) applied to [n, 3] points (+normals). Returns
    (T [4,4], points', normals'?)."""
    rs = rs or np.random.RandomState(0)
    x = rs.rand(6)
    degree = rs.rand(1)[0] * max_degree * np.pi / 180.0
    amp = rs.rand(1)[0] * max_amp
    w, v = x[:3], x[3:]
    w = w / max(np.linalg.norm(w), 1e-12) * degree
    v = v / max(np.linalg.norm(v), 1e-12) * amp
    theta = np.linalg.norm(w)
    if theta < 1e-12:
        rot = np.eye(3)
    else:
        k = w / theta
        kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        rot = np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * kx @ kx
    t = np.eye(4, dtype=np.float64)
    t[:3, :3] = rot
    t[:3, 3] = v
    out_pts = (points @ rot.T + v).astype(np.float32)
    if normals is not None:
        return t, out_pts, (normals @ rot.T).astype(np.float32)
    return t, out_pts


def randchoice(rs: np.random.RandomState, n: int, num_samples: int) -> np.ndarray:
    """Without replacement when possible (ref: utils/random_choice.py:2-7)."""
    return rs.choice(n, num_samples, replace=n < num_samples)


def jitter(pcd: np.ndarray, sigma: float = 0.01, clip: float | None = 0.05,
           rs: np.random.RandomState | None = None) -> np.ndarray:
    """Gaussian xyz noise, optionally clipped (ref: deepgmr_partial.py:98-106)."""
    rs = rs or np.random.RandomState(0)
    noise = sigma * rs.randn(pcd.shape[0], 3)
    if clip:
        noise = np.clip(noise, -clip, clip)
    out = pcd.copy()
    out[:, :3] = out[:, :3] + noise.astype(pcd.dtype)
    return out


def half_space_crop(pcd: np.ndarray, p_keep: float,
                    rs: np.random.RandomState) -> np.ndarray:
    """RPM-Net crop: keep the p_keep fraction on one side of a random plane
    through the centroid (its normal uniform on the 2-sphere)."""
    phi = rs.uniform(0, 2 * np.pi)
    cos_theta = rs.uniform(-1.0, 1.0)
    sin_theta = np.sqrt(max(1 - cos_theta**2, 0.0))
    direction = np.array([sin_theta * np.cos(phi), sin_theta * np.sin(phi), cos_theta])
    pts = pcd[:, :3] - pcd[:, :3].mean(0, keepdims=True)
    dist = pts @ direction
    thresh = np.percentile(dist, (1 - p_keep) * 100.0)
    return pcd[dist > thresh]


def resample(pcd: np.ndarray, num_points: int,
             rs: np.random.RandomState) -> np.ndarray:
    """`num_points` rows of `pcd` by `randchoice`."""
    return pcd[randchoice(rs, pcd.shape[0], num_points)]


def zbuffer_crop(pcd: np.ndarray, grid_num: int = 200) -> np.ndarray:
    """2.5-D visibility crop: keep the min-z point of each occupied xy cell
    (ref: deepgmr_partial.py project()). pcd [n, >=3] -> [m, k] subset."""
    pts = pcd[:, :3]
    centered = pts - pts.mean(0, keepdims=True)
    lo = centered.min(0)
    hi = centered.max(0)
    bound = 2 * (centered - lo) / np.maximum(hi - lo, 1e-9)
    gxy = np.floor(bound[:, :2] / (2.0 / grid_num)).astype(np.int64)
    gid = gxy[:, 0] + gxy[:, 1] * grid_num
    order = np.argsort(bound[:, 2], kind="stable")  # nearest (min z) first
    _, first = np.unique(gid[order], return_index=True)
    keep = np.sort(order[first])
    return pcd[keep]


def quantile_band_crop(pcd: np.ndarray, lo: float, hi: float,
                       direction: np.ndarray) -> np.ndarray:
    """Keep points whose projection onto `direction` lies in the [lo, hi]
    quantile band of this cloud (the partialK modes' controlled-overlap
    crop); a band of fewer than 8 points keeps the whole cloud."""
    pts = pcd[:, :3] - pcd[:, :3].mean(0, keepdims=True)
    dist = pts @ np.asarray(direction, pcd.dtype)
    lo_t = np.percentile(dist, max(lo, 0.0) * 100.0)
    hi_t = np.percentile(dist, min(hi, 1.0) * 100.0)
    keep = (dist >= lo_t) & (dist <= hi_t)
    if keep.sum() < 8:  # degenerate band: fall back to the whole cloud
        return pcd
    return pcd[keep]


@dataclass
class PairBatch:
    source: np.ndarray      # [b, n, 3]
    target: np.ndarray      # [b, n, 3]
    transform: np.ndarray   # [b, 4, 4] ground truth source -> target


class _Pairs:
    """`arrays` and `batches` of a pair source whose item i is (source
    [n, 3], target [n, 3], ground-truth transform [4, 4])."""

    def arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All pairs stacked: (source [m, n, 3], target [m, n, 3], T [m, 4, 4])."""
        items = [self[i] for i in range(len(self))]
        return tuple(np.stack([it[j] for it in items]) for j in range(3))

    def batches(self, batch_size: int = 1) -> Iterator[PairBatch]:
        """Consecutive pairs, `batch_size` at a time (the last batch may be
        shorter)."""
        for start in range(0, len(self), batch_size):
            items = [self[i] for i in range(start, min(start + batch_size, len(self)))]
            yield PairBatch(source=np.stack([a for a, _, _ in items]),
                            target=np.stack([b for _, b, _ in items]),
                            transform=np.stack([t for _, _, t in items]))


class H5TestPairs(_Pairs):
    """A DeepGMR-format h5 file: datasets 'source', 'target' and
    'transform'; item i keeps the first `num_points` points of each cloud.
    Needs h5py, imported here only."""

    def __init__(self, path: str, num_points: int = 1024):
        import h5py

        with h5py.File(path, "r") as f:
            self.source = f["source"][...].astype(np.float32)
            self.target = f["target"][...].astype(np.float32)
            self.transform = f["transform"][...].astype(np.float32)
        self.num_points = num_points

    def __len__(self) -> int:
        return self.transform.shape[0]

    def __getitem__(self, index: int):
        n = self.num_points
        return self.source[index][:n], self.target[index][:n], self.transform[index]


class SyntheticPairs(_Pairs):
    """Registration pairs from procedural shapes. Modes: 'clean' (full
    clouds); 'noise' (+ clipped Gaussian noise on both clouds); 'partial'
    (independent 2.5-D z-buffer crops of both clouds before resampling,
    then the noise); 'partialK', e.g. 'partial0.5' (on top of the z-buffer
    crops, quantile-band crops along a common world direction: the source
    keeps a 0.5-wide band, the target a 0.65-wide one placed so that a
    fraction K of the source's band has a counterpart). Item i is (source
    [n, 3], target [n, 3], ground-truth transform [4, 4]), all f32."""

    def __init__(self, num_pairs: int = 100, num_points: int = 1024,
                 mode: str = "noise", max_degree: float = 360.0,
                 max_amp: float = 0.5, noise_sigma: float = 0.01,
                 noise_clip: float = 0.05, seed: int = 0):
        self.keep = None
        if mode.startswith("partial") and mode != "partial":
            self.keep = float(mode[len("partial"):])
            if not 0.1 <= self.keep <= 1.0:
                raise ValueError(f"pair mode {mode!r}: the overlap must be in [0.1, 1]")
            mode = "partial"
        if mode not in ("clean", "noise", "partial"):
            raise ValueError(f"unknown pair mode {mode!r}")
        self.num_pairs = num_pairs
        self.num_points = num_points
        self.mode = mode
        self.max_degree = max_degree
        self.max_amp = max_amp
        self.noise_sigma = noise_sigma
        self.noise_clip = noise_clip
        self.seed = seed

    def __len__(self) -> int:
        return self.num_pairs

    def __getitem__(self, index: int):
        rs = np.random.RandomState(self.seed * 1_000_003 + index)
        label = rs.randint(0, NUM_CLASSES)
        cloud = make_cloud(label, 4096, seed=index + 17, with_normals=False)
        trans, moved = random_rotation(cloud, None, self.max_degree,
                                       self.max_amp, rs=rs)
        src, dst = cloud, moved
        if self.mode == "partial":
            src = zbuffer_crop(src)
            dst = zbuffer_crop(dst)
            if self.keep is not None:
                k, ws, wd = self.keep, 0.5, 0.65
                u = rs.randn(3)
                u = (u / np.linalg.norm(u)).astype(np.float32)
                # The target's frame sees the world direction u as R·u.
                src = quantile_band_crop(src, 1.0 - ws, 1.0, u)
                dst = quantile_band_crop(dst, 1.0 - ws - wd + k * ws, 1.0 - ws + k * ws,
                                         trans[:3, :3] @ u)
        src = src[randchoice(rs, src.shape[0], self.num_points)]
        dst = dst[randchoice(rs, dst.shape[0], self.num_points)]
        if self.mode in ("noise", "partial"):
            src = jitter(src, self.noise_sigma, self.noise_clip, rs)
            dst = jitter(dst, self.noise_sigma, self.noise_clip, rs)
        return (src.astype(np.float32), dst.astype(np.float32),
                trans.astype(np.float32))


class SequencePairs(_Pairs):
    """Adjacent-scan pairs of the synthetic indoor trajectory
    (`data/sequences.py`, the ICL-NUIM analog) of `num_pairs + 1` scans:
    pair k is (scan_k, scan_{k+1}) with ground truth T_{k+1}⁻¹ T_k."""

    def __init__(self, num_pairs: int = 100, num_points: int = 1024, seed: int = 0,
                 crop: bool = False):
        from .sequences import SequenceConfig, SyntheticSequence

        self.seq = SyntheticSequence(SequenceConfig(num_scans=num_pairs + 1,
                                                    num_points=num_points, seed=seed, crop=crop))
        self.num_pairs = num_pairs

    def __len__(self) -> int:
        return self.num_pairs

    def __getitem__(self, index: int):
        return (self.seq.scans[index], self.seq.scans[index + 1],
                self.seq.relative_gt(index, index + 1))


def get_pairs(path: str | None, num_points: int = 1024, mode: str = "noise",
              num_pairs: int = 100) -> _Pairs:
    """The evaluation's pairs, in the reference's order: the h5 test file
    at `path` when it is a file; else the adjacent scans of the indoor
    trajectory for mode 'icl_nuim'; else synthetic pairs of `mode`."""
    if path and os.path.isfile(path):
        return H5TestPairs(path, num_points)
    if mode == "icl_nuim":
        return SequencePairs(num_pairs=num_pairs, num_points=num_points)
    return SyntheticPairs(num_pairs=num_pairs, num_points=num_points, mode=mode)
