"""Multi-scan sequences, a numpy copy of `rift_tpu/data/sequences.py`: the
synthetic indoor trajectory (the ICL-NUIM analog: a 2 × 2 × 1.2 room of
floor, four walls and procedural objects, seen from a smooth orbit with
per-scan resampling, an optional z-buffer crop and clipped sensor noise)
and the h5 sequence reader. The same `SequenceConfig` gives the same
`scans` and `gt_poses` as the original.

`gt_poses[i]` is world-from-scan; scan points are camera-local,
y = T_i⁻¹ · X; the map scan_i → scan_j is M_ij = T_j⁻¹ T_i.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .synthetic_pairs import NUM_CLASSES, make_cloud, randchoice, zbuffer_crop


@dataclass(slots=True)
class SequenceConfig:
    num_scans: int = 24
    num_points: int = 1024
    scene_points: int = 16384
    num_objects: int = 5
    noise_sigma: float = 0.004
    noise_clip: float = 0.02
    crop: bool = False            # per-viewpoint z-buffer visibility crop
    orbit_radius: float = 0.45    # camera path radius inside the room
    orbit_degrees: float = 360.0  # total yaw swept by the trajectory
    height_wobble: float = 0.12   # vertical camera oscillation
    seed: int = 0
    path: str | None = None       # h5 file with 'scans' and 'poses' instead of synthesis


def make_room_scene(num_points: int, num_objects: int = 5, seed: int = 0) -> np.ndarray:
    """The static scene [n, 3]: floor z = 0 and walls x, y = ±1 up to
    z = 1.2 (half the points, by area), then `num_objects` procedural
    objects standing on the floor."""
    rs = np.random.RandomState(seed)
    n_struct = num_points // 2
    areas = np.array([4.0, 2.4, 2.4, 2.4, 2.4])
    counts = np.maximum((areas / areas.sum() * n_struct).astype(int), 1)
    parts = []
    f = rs.uniform(-1, 1, (counts[0], 2))
    parts.append(np.stack([f[:, 0], f[:, 1], np.zeros(counts[0])], -1))
    for i, (axis, sign) in enumerate([(0, -1), (0, 1), (1, -1), (1, 1)]):
        u = rs.uniform(-1, 1, counts[i + 1])
        z = rs.uniform(0, 1.2, counts[i + 1])
        wall = np.zeros((counts[i + 1], 3))
        wall[:, axis] = sign
        wall[:, 1 - axis] = u
        wall[:, 2] = z
        parts.append(wall)
    n_obj_pts = (num_points - sum(counts)) // max(num_objects, 1)
    for k in range(num_objects):
        label = rs.randint(0, NUM_CLASSES)
        obj = make_cloud(label, n_obj_pts, seed=seed * 31 + k, with_normals=False)
        scale = rs.uniform(0.15, 0.3)
        obj = obj * scale
        center = np.array([rs.uniform(-0.7, 0.7), rs.uniform(-0.7, 0.7), scale + 0.02])
        parts.append(obj + center)
    scene = np.concatenate(parts, 0).astype(np.float32)
    return scene[:num_points] if len(scene) > num_points else scene


def make_trajectory(config: SequenceConfig) -> np.ndarray:
    """World-from-camera poses [T, 4, 4]: an orbit inside the room with a
    height wobble, the camera yawing along the path and pitching a little."""
    t = config.num_scans
    angles = np.deg2rad(config.orbit_degrees) * np.arange(t) / max(t, 1)
    poses = np.zeros((t, 4, 4), np.float32)
    for i, a in enumerate(angles):
        pos = np.array([config.orbit_radius * np.cos(a), config.orbit_radius * np.sin(a),
                        0.55 + config.height_wobble * np.sin(3 * a)])
        cy, sy = np.cos(a), np.sin(a)
        yaw = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
        pitch_a = 0.15 * np.cos(2 * a)
        cp, sp = np.cos(pitch_a), np.sin(pitch_a)
        pitch = np.array([[1.0, 0.0, 0.0], [0.0, cp, -sp], [0.0, sp, cp]])
        poses[i, :3, :3] = yaw @ pitch
        poses[i, :3, 3] = pos
        poses[i, 3, 3] = 1.0
    return poses


class SyntheticSequence:
    """Scans [T, n, 3] (camera-local) and world-from-scan poses [T, 4, 4],
    synthesized from `config`, or read from `config.path` (an h5 file with
    'scans' and 'poses'; needs h5py). The scene comes first from one
    RandomState(seed), then per scan a resampling and a noise draw."""

    def __init__(self, config: SequenceConfig | None = None):
        self.config = config or SequenceConfig()
        cfg = self.config
        if cfg.path:
            import h5py

            with h5py.File(cfg.path, "r") as f:
                self.scans = f["scans"][...].astype(np.float32)
                self.gt_poses = f["poses"][...].astype(np.float32)
            return
        rs = np.random.RandomState(cfg.seed)
        scene = make_room_scene(cfg.scene_points, cfg.num_objects, cfg.seed)
        self.gt_poses = make_trajectory(cfg)
        scans = []
        for pose in self.gt_poses:
            rot, pos = pose[:3, :3], pose[:3, 3]
            local = (scene - pos) @ rot  # Rᵀ (X - p)
            if cfg.crop:
                local = zbuffer_crop(local)
            local = local[randchoice(rs, local.shape[0], cfg.num_points)]
            if cfg.noise_sigma:
                noise = np.clip(rs.randn(*local.shape) * cfg.noise_sigma,
                                -cfg.noise_clip, cfg.noise_clip)
                local = local + noise
            scans.append(local.astype(np.float32))
        self.scans = np.stack(scans)

    def __len__(self) -> int:
        return self.scans.shape[0]

    def relative_gt(self, i: int, j: int) -> np.ndarray:
        """The ground-truth map scan_i → scan_j, M_ij = T_j⁻¹ T_i, f32."""
        return (np.linalg.inv(self.gt_poses[j]) @ self.gt_poses[i]).astype(np.float32)


def get_sequence(config: SequenceConfig | None = None) -> SyntheticSequence:
    return SyntheticSequence(config)
