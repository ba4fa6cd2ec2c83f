"""The port's host C++ libraries (`csrc/host/*.cpp`), built by g++ and
bound with `ctypes`.

Each source is compiled at the first call that needs it, never at import,
by `g++ -O3 -shared -fPIC -std=c++17` into
`rift_tpu_torch/_build/lib<stem>-<hash of the source and flags>.so`. The
library is written under a temporary name and renamed, so concurrent first
calls never load half a file. Nothing is written beside the source.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Callable

from ..ops.cuda.build import BUILD_DIR, CSRC

HOST_SRC = os.path.join(CSRC, "host")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def library_path(source: str, stem: str) -> str:
    """Where the shared library of `source`'s current text is (or will be) built."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")


def load_library(source: str, stem: str,
                 declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Build `source` (once per text) and load it; `declare` sets the
    argtypes and restype of every function the caller uses."""
    path = library_path(source, stem)
    with _lock:
        lib = _loaded.get(path)
        if lib is not None:
            return lib
        if not os.path.isfile(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.tmp{os.getpid()}"
            proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, source],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {source} (exit {proc.returncode}):\n"
                                   f"{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        declare(lib)
        _loaded[path] = lib
        return lib
