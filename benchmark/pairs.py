"""Inputs of the cells, made from the seed: a frozen numpy copy of the port's
procedural shapes and noise pairs (`data/synthetic_pairs.py`:
`make_cloud`, `random_rotation`, `jitter`, and `SyntheticPairs`' 'noise'
mode at its defaults), so that no later change to the program moves the
traffic.

Each item draws from its own `RandomState`, seeded from the run's seed and
the item's index through `SeedSequence` (any seed up to 2**63 works; the
port's `seed * 1_000_003 + index` overflows RandomState's 32 bits). Every
seed gives items of the same sizes: the seed changes the shapes, poses and
noise, never the work's shape.
"""
from __future__ import annotations

import numpy as np

NUM_CLASSES = 40


def item_state(seed: int, stream: int, index: int) -> np.random.RandomState:
    """The RandomState of item `index` of one stream of a run's inputs."""
    return np.random.RandomState(
        np.random.SeedSequence([int(seed) % 2 ** 63, stream, index]).generate_state(1)[0])


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


def noise_pairs(seed: int, count: int, num_points: int = 1024, max_degree: float = 360.0,
                max_amp: float = 0.5, noise_sigma: float = 0.01, noise_clip: float = 0.05
                ) -> tuple[np.ndarray, np.ndarray]:
    """`count` noise pairs (source, target), [count, n, 3] f32 each:
    `SyntheticPairs(mode='noise')`'s item with its own RandomState: a cloud
    of 4096 points of a random class, a random rigid motion (rotation up to
    `max_degree`, translation up to `max_amp`), `num_points` of each side
    resampled and clipped Gaussian noise on both."""
    src_all, dst_all = [], []
    for index in range(count):
        rs = item_state(seed, 1, index)
        label = rs.randint(0, NUM_CLASSES)
        cloud = make_cloud(label, 4096, seed=int(rs.randint(0, 2 ** 31)), with_normals=False)
        _, moved = random_rotation(cloud, None, max_degree, max_amp, rs=rs)
        src = cloud[randchoice(rs, cloud.shape[0], num_points)]
        dst = moved[randchoice(rs, moved.shape[0], num_points)]
        src_all.append(jitter(src, noise_sigma, noise_clip, rs))
        dst_all.append(jitter(dst, noise_sigma, noise_clip, rs))
    return np.stack(src_all).astype(np.float32), np.stack(dst_all).astype(np.float32)


def class_clouds(seed: int, count: int, num_points: int = 1024, max_degree: float = 360.0,
                 max_amp: float = 3.0) -> tuple[np.ndarray, np.ndarray]:
    """`count` labelled clouds with normals ([count, n, 6] f32, labels
    [count] int64), the synthetic ModelNet40 items of the training
    configuration: `make_cloud` of a random class, randomly rotated (and
    moved by up to `max_amp`) with its normals."""
    clouds, labels = [], []
    for index in range(count):
        rs = item_state(seed, 2, index)
        label = int(rs.randint(0, NUM_CLASSES))
        cloud = make_cloud(label, num_points, seed=int(rs.randint(0, 2 ** 31)))
        _, pts, nrm = random_rotation(cloud[:, :3], cloud[:, 3:], max_degree, max_amp, rs=rs)
        clouds.append(np.concatenate([pts, nrm], -1))
        labels.append(label)
    return np.stack(clouds).astype(np.float32), np.asarray(labels, dtype=np.int64)
