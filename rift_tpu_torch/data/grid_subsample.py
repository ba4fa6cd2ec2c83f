"""Grid subsampling, twin of `rift_tpu/data/grid_subsample.py`: barycenter
downsample of points, features and labels over a regular voxel grid.

The work is host C++ (`csrc/host/grid_subsample.cpp`, the port's copy of
`cpp/grid_subsample.cpp`), bound with `ctypes` and built by g++ at the
first call into `rift_tpu_torch/_build/libgrid_subsample-<hash>.so`
(`utils.host_build`). Nothing is written beside the source.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from ..utils import host_build

SOURCE = os.path.join(host_build.HOST_SRC, "grid_subsample.cpp")


def library_path() -> str:
    """Where the shared library of the current source is (or will be) built."""
    return host_build.library_path(SOURCE, "grid_subsample")


def _declare(lib: ctypes.CDLL) -> None:
    fptr, iptr = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    lib.grid_subsample_count.restype = ctypes.c_int64
    lib.grid_subsample_count.argtypes = [fptr, ctypes.c_int64, ctypes.c_float]
    lib.grid_subsample.restype = ctypes.c_int64
    lib.grid_subsample.argtypes = [fptr, ctypes.c_int64, fptr, ctypes.c_int64, iptr,
                                   ctypes.c_float, fptr, fptr, iptr, ctypes.c_int64]


def load() -> ctypes.CDLL:
    """Build (once per source) and load the library, declaring its C ABI."""
    return host_build.load_library(SOURCE, "grid_subsample", _declare)


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
