"""Build and load the port's CUDA kernels at their first launch.

Each source under `rift_tpu_torch/csrc/*.cu` is compiled for `sm_90a` by
its own `nvcc` process, all started together; one more `nvcc` links the
objects into `rift_tpu_torch/_build/librift_kernels.so`, a shared library
with a plain C interface, loaded with `ctypes`. No source includes
PyTorch's headers, so the build takes seconds. The library is rebuilt only
when the hash of the sources changes. Nothing here runs at import time:
`import rift_tpu_torch` needs no compiler.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_NAME = "librift_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
# Every pointer and the stream are c_void_p: ctypes' default int would cut a
# 64-bit address.
_SIGNATURES = {
    "rift_normals_moments": [_P, _P, _I, _I, _I, ctypes.c_float, _P],
    "rift_scatter_mean": [_P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "rift_corner_gather": [_P, _I, _P, _I, _P, _I, _I, _I, _I, _P, _P],
    "rift_corner_scatter": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    "rift_conv3d_same": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
}


_lock = threading.Lock()
_loaded: ctypes.CDLL | None = None
# Path of the loaded library and seconds its build took (0 when an
# up-to-date library was found); set by load().
lib_path: str | None = None
build_seconds: float | None = None


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); the CUDA kernels "
                           "cannot be built")
    return found


_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]


def nvcc_commands(out_path: str, obj_dir: str) -> tuple[list[list[str]], list[str]]:
    """One compile command per source (run in parallel) and the link."""
    nvcc = _nvcc()
    objs, compiles = [], []
    for src in _sources():
        obj = os.path.join(obj_dir, os.path.basename(src) + ".o")
        compiles.append([nvcc, *_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-c", src,
                         "-o", obj])
        objs.append(obj)
    return compiles, [nvcc, *_ARCH, "-shared", "-o", out_path, *objs]


def _run_build(out_path: str) -> None:
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as obj_dir:
        compiles, link = nvcc_commands(out_path, obj_dir)
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for cmd in compiles]
        failed = []
        for cmd, proc in zip(compiles, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(cmd[-3])} (exit {proc.returncode}):\n{err}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}):\n{proc.stderr}")


def _digest() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _read(path: str) -> str | None:
    try:
        with open(path) as f:
            return f.read().strip()
    except FileNotFoundError:
        return None


def load() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library."""
    global _loaded, lib_path, build_seconds
    with _lock:
        if _loaded is not None:
            return _loaded
        os.makedirs(BUILD_DIR, exist_ok=True)
        path = os.path.join(BUILD_DIR, LIB_NAME)
        stamp = path + ".sha256"
        digest = _digest()
        seconds = 0.0
        if not (os.path.isfile(path) and _read(stamp) == digest):
            tmp = path + f".tmp{os.getpid()}"
            t0 = time.perf_counter()
            _run_build(tmp)
            seconds = time.perf_counter() - t0
            os.replace(tmp, path)
            with open(stamp, "w") as f:
                f.write(digest + "\n")
        lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded, lib_path, build_seconds = lib, path, seconds
        return _loaded


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
