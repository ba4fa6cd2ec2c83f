"""Zstandard decompression on a machine without the zstd library: a
`ctypes` binding of `csrc/host/zstd_decode.cpp` (RFC 8878, no
dictionaries), built by g++ at the first call (`host_build`).

`decompress` decodes every frame of a buffer (skippable frames skipped,
content checksums checked) and raises `ZstdError`, with the byte offset,
on malformed input or a frame that names a dictionary.
"""
from __future__ import annotations

import ctypes
import os

from . import host_build

SOURCE = os.path.join(host_build.HOST_SRC, "zstd_decode.cpp")
_ERR_BYTES = 512


class ZstdError(ValueError):
    """Input that is not valid zstd, or that needs a dictionary."""


def _declare(lib: ctypes.CDLL) -> None:
    out_p = ctypes.POINTER(ctypes.c_void_p)
    lib.rift_zstd_decompress.restype = ctypes.c_int
    lib.rift_zstd_decompress.argtypes = [ctypes.c_char_p, ctypes.c_size_t, out_p,
                                         ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p,
                                         ctypes.c_size_t]
    lib.rift_zstd_free.restype = None
    lib.rift_zstd_free.argtypes = [ctypes.c_void_p]


def load() -> ctypes.CDLL:
    return host_build.load_library(SOURCE, "zstd_decode", _declare)


def library_path() -> str:
    """Where the decoder of the current source is (or will be) built."""
    return host_build.library_path(SOURCE, "zstd_decode")


def decompress(data: bytes) -> bytes:
    """The concatenated content of every zstd frame in `data`."""
    lib = load()
    data = bytes(data)
    out = ctypes.c_void_p()
    size = ctypes.c_size_t()
    err = ctypes.create_string_buffer(_ERR_BYTES)
    if lib.rift_zstd_decompress(data, len(data), ctypes.byref(out), ctypes.byref(size),
                                err, _ERR_BYTES):
        raise ZstdError(err.value.decode(errors="replace"))
    try:
        return ctypes.string_at(out, size.value)
    finally:
        lib.rift_zstd_free(out)
