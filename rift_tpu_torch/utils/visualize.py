"""Headless visualization tools: PLY export for clouds, keypoints and
correspondences, and a PLY/PCD reader; a copy of
`rift_tpu/utils/visualize.py` (numpy only).

Capability parity with `o3d_tools/visualize_tools.py` (colored clouds,
keypoint markers, correspondence line sets) without an Open3D/GUI
dependency: artifacts are ASCII PLY files viewable in any point-cloud
viewer (MeshLab, CloudCompare, Open3D elsewhere).
"""
from __future__ import annotations

import numpy as np

FRAG1_COLOR = (227, 26, 28)    # red (source)
FRAG2_COLOR = (31, 120, 180)   # blue (target)
KEYPOINT_COLOR = (51, 160, 44)
LINE_COLOR = (255, 127, 0)


def save_pcd_ply(path: str, points: np.ndarray,
                 color: tuple[int, int, int] = FRAG1_COLOR,
                 colors: np.ndarray | None = None) -> None:
    """Write [n, 3] points as ASCII PLY (uniform or per-point uint8 colors)."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    if colors is None:
        colors = np.tile(np.asarray(color, np.uint8), (len(points), 1))
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p, c in zip(points, colors):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}\n")


def save_registration_ply(path: str, source: np.ndarray, target: np.ndarray,
                          transform: np.ndarray | None = None) -> None:
    """Source (optionally transformed) + target in one colored PLY."""
    source = np.asarray(source, np.float32)
    if transform is not None:
        source = source @ np.asarray(transform)[:3, :3].T + np.asarray(transform)[:3, 3]
    pts = np.concatenate([source, np.asarray(target, np.float32)])
    colors = np.concatenate([
        np.tile(np.asarray(FRAG1_COLOR, np.uint8), (len(source), 1)),
        np.tile(np.asarray(FRAG2_COLOR, np.uint8), (len(target), 1)),
    ])
    save_pcd_ply(path, pts, colors=colors)


def save_correspondences_ply(path: str, source: np.ndarray, target: np.ndarray,
                             idx1: np.ndarray, idx2: np.ndarray,
                             mask: np.ndarray | None = None) -> None:
    """Correspondence line set as a PLY with edges
    (ref: visualize_correspondences)."""
    source = np.asarray(source, np.float32)
    target = np.asarray(target, np.float32)
    idx1 = np.asarray(idx1)
    idx2 = np.asarray(idx2)
    if mask is not None:
        keep = np.asarray(mask).astype(bool)
        idx1, idx2 = idx1[keep], idx2[keep]
    a = source[idx1]
    b = target[idx2]
    verts = np.concatenate([a, b])
    e = len(a)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element edge {e}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        f.write("end_header\n")
        for p in verts:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for i in range(e):
            f.write(f"{i} {i + e}\n")


def read_pcd_ply(path: str) -> tuple[np.ndarray, np.ndarray | None]:
    """Read points (+ optional uint8 colors) from an ASCII/binary PLY or an
    ASCII PCD file.

    Capability parity with the reference's `read_pcd_ply`
    (`o3d_tools/visualize_tools.py`), which round-trips through Open3D;
    here both formats are parsed directly. Returns
    (points [n, 3] float32, colors [n, 3] uint8 or None).
    """
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic[:3] == b"ply":
        return _read_ply(path)
    return _read_pcd(path)


def _read_ply(path: str) -> tuple[np.ndarray, np.ndarray | None]:
    _PLY_DTYPES = {
        "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
        "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
        "short": "i2", "ushort": "u2", "int": "i4", "int32": "i4",
        "uint": "u4", "uint32": "u4",
    }
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n_vertex = 0
        props: list[tuple[str, str]] = []  # (name, numpy dtype) vertex props
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: truncated PLY header")
            tok = line.decode("ascii", "replace").split()
            if not tok:
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                in_vertex = tok[1] == "vertex"
                if in_vertex:
                    n_vertex = int(tok[2])
            elif tok[0] == "property" and in_vertex:
                if tok[1] == "list":
                    raise ValueError(f"{path}: list vertex properties unsupported")
                props.append((tok[2], _PLY_DTYPES[tok[1]]))
            elif tok[0] == "end_header":
                break
        names = [p[0] for p in props]
        if fmt == "ascii":
            rows = np.loadtxt(
                [f.readline() for _ in range(n_vertex)],
                dtype=np.float64, ndmin=2,
            )
            rec = {nm: rows[:, i] for i, (nm, _) in enumerate(props)}
        else:
            endian = "<" if fmt == "binary_little_endian" else ">"
            dt = np.dtype([(nm, endian + d) for nm, d in props])
            raw = np.frombuffer(f.read(dt.itemsize * n_vertex), dtype=dt,
                                count=n_vertex)
            rec = {nm: raw[nm] for nm in names}
    pts = np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float32)
    colors = None
    if all(k in rec for k in ("red", "green", "blue")):
        colors = np.stack([rec["red"], rec["green"], rec["blue"]],
                          axis=1).astype(np.uint8)
    return pts, colors


def _read_pcd(path: str) -> tuple[np.ndarray, np.ndarray | None]:
    """Minimal ASCII PCD v0.7 reader (x y z [+ packed float rgb])."""
    fields: list[str] = []
    n = 0
    data_started = False
    rows = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            if data_started:
                rows.append([float(v) for v in tok])
                continue
            key = tok[0].upper()
            if key == "FIELDS":
                fields = [t.lower() for t in tok[1:]]
            elif key == "POINTS":
                n = int(tok[1])
            elif key == "DATA":
                if tok[1] != "ascii":
                    raise ValueError(f"{path}: only ASCII PCD supported")
                data_started = True
    arr = np.asarray(rows, np.float64)
    if n and len(arr) != n:
        raise ValueError(f"{path}: POINTS={n} but parsed {len(arr)} rows")
    ix = {name: i for i, name in enumerate(fields)}
    pts = arr[:, [ix["x"], ix["y"], ix["z"]]].astype(np.float32)
    colors = None
    if "rgb" in ix:
        packed = arr[:, ix["rgb"]].astype(np.float32).view(np.uint32)
        colors = np.stack([(packed >> 16) & 0xFF, (packed >> 8) & 0xFF,
                           packed & 0xFF], axis=1).astype(np.uint8)
    return pts, colors
