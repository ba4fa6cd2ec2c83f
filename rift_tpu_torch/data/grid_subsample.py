"""Grid subsampling, twin of `rift_tpu/data/grid_subsample.py`: barycenter
downsample of points, features and labels over a regular voxel grid.

The work is host C++ (`csrc/host/grid_subsample.cpp`, the port's copy of
`cpp/grid_subsample.cpp`), bound with `ctypes`. It is compiled at the
first call, never at import, by `g++ -O3 -shared -fPIC -std=c++17` into
`rift_tpu_torch/_build/libgrid_subsample-<hash of the source>.so`
(written under a temporary name and renamed, so concurrent first calls
never load half a file). Nothing is written beside the source.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..ops.cuda.build import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "csrc", "host", "grid_subsample.cpp")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> str:
    """Where the shared library of the current source is (or will be) built."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libgrid_subsample-{digest}.so")


def load() -> ctypes.CDLL:
    """Build (once per source) and load the library, declaring its C ABI."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.isfile(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.tmp{os.getpid()}"
            proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        fptr, iptr = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
        lib.grid_subsample_count.restype = ctypes.c_int64
        lib.grid_subsample_count.argtypes = [fptr, ctypes.c_int64, ctypes.c_float]
        lib.grid_subsample.restype = ctypes.c_int64
        lib.grid_subsample.argtypes = [fptr, ctypes.c_int64, fptr, ctypes.c_int64, iptr,
                                       ctypes.c_float, fptr, fptr, iptr, ctypes.c_int64]
        _lib = lib
        return lib


def _fptr(a: np.ndarray | None):
    return None if a is None else a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray | None):
    return None if a is None else a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def grid_subsample(points: np.ndarray, features: np.ndarray | None = None,
                   labels: np.ndarray | None = None, sample_dl: float = 0.1):
    """Barycenter grid downsample at voxel size `sample_dl`.

    points [n, 3] float32; features [n, f] float32 (mean-pooled); labels
    [n] int32 (majority vote, the lower label on ties). Returns the
    subsampled arrays in the combination passed (points alone, or a
    tuple), one row per occupied voxel in first-seen order.
    """
    lib = load()
    points = np.ascontiguousarray(points, np.float32)
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be [n, 3], got {points.shape}")
    n = points.shape[0]
    if n == 0 or not sample_dl > 0:
        raise ValueError(f"grid_subsample needs points and sample_dl > 0 (n={n}, "
                         f"sample_dl={sample_dl})")
    fdim = 0
    if features is not None:
        features = np.ascontiguousarray(features, np.float32)
        if features.ndim != 2 or features.shape[0] != n:
            raise ValueError(f"features must be [{n}, f], got {features.shape}")
        fdim = features.shape[1]
    if labels is not None:
        labels = np.ascontiguousarray(labels, np.int32)
        if labels.shape != (n,):
            raise ValueError(f"labels must be [{n}], got {labels.shape}")
    m = lib.grid_subsample_count(_fptr(points), n, sample_dl)
    out_points = np.empty((m, 3), np.float32)
    out_features = None if features is None else np.empty((m, fdim), np.float32)
    out_labels = None if labels is None else np.empty((m,), np.int32)
    written = lib.grid_subsample(_fptr(points), n, _fptr(features), fdim, _iptr(labels),
                                 sample_dl, _fptr(out_points), _fptr(out_features),
                                 _iptr(out_labels), m)
    if written != m:
        raise RuntimeError(f"grid_subsample wrote {written} != {m} cells")
    out = [a for a in (out_points, out_features, out_labels) if a is not None]
    return out[0] if len(out) == 1 else tuple(out)
