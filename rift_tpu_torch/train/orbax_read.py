"""Orbax checkpoints read without orbax or tensorstore: the directories that
`rift_tpu/train/checkpoint.py:CheckpointManager` writes (a
`StandardCheckpointer` with OCDBT and zarr v2), read with numpy, the
port's OCDBT reader (`ocdbt.OcdbtStore`) and its zstd decoder.

`_METADATA` is JSON whose `tree_metadata` maps each leaf's key path (as the
string of a tuple) to its keys, each a dict key (`key_type` 2) or a
sequence index (1), and its value type: "jax.Array" or "None" (the only
two the reference's training states hold; any other raises). A leaf
`('params', 'Dense_0', 'kernel')` is the zarr v2 array under the OCDBT
prefix `params.Dense_0.kernel/`: its `.zarray` (dtype, shape, chunk shape,
compressor) and one value per chunk, keyed by the chunk's grid indices
joined by `.` (`0` for a 0-d array).
"""
from __future__ import annotations

import itertools
import json
import os

import numpy as np

from ..utils.zstd import decompress
from .ocdbt import OcdbtStore

DTYPES = ("<f2", "<f4", "<f8", "|i1", "<i2", "<i4", "<i8", "|u1", "<u2", "<u4", "<u8", "|b1")
DICT_KEY, SEQUENCE_KEY = 2, 1


class OrbaxFormatError(ValueError):
    """A checkpoint this reader does not know how to read."""


def is_orbax_dir(path: str) -> bool:
    """Whether `path` is an orbax checkpoint directory (it has `_METADATA`)."""
    return os.path.isfile(os.path.join(path, "_METADATA"))


def read_zarr(store: OcdbtStore, prefix: str) -> np.ndarray:
    """The zarr v2 array stored under `prefix` (no trailing slash)."""
    meta = json.loads(store.read(f"{prefix}/.zarray"))
    if meta.get("zarr_format") != 2:
        raise OrbaxFormatError(f"{prefix}: zarr_format {meta.get('zarr_format')}, expected 2")
    dtype = meta["dtype"]
    if not isinstance(dtype, str) or dtype not in DTYPES:
        raise OrbaxFormatError(f"{prefix}: unsupported dtype {dtype!r}")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise OrbaxFormatError(f"{prefix}: unsupported compressor {compressor!r}")
    if meta.get("filters"):
        raise OrbaxFormatError(f"{prefix}: filters {meta['filters']!r} are not supported")
    if meta.get("order", "C") != "C":
        raise OrbaxFormatError(f"{prefix}: order {meta['order']!r}, only C is supported")
    sep = meta.get("dimension_separator", ".")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks):
        raise OrbaxFormatError(f"{prefix}: shape {shape} and chunks {chunks} differ in rank")
    np_dtype = np.dtype(dtype)
    out = np.empty(shape, np_dtype)
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * np_dtype.itemsize
    for index in itertools.product(*grid):
        key = f"{prefix}/{sep.join(map(str, index)) if index else '0'}"
        try:
            raw = store.read(key)
        except KeyError:
            raise OrbaxFormatError(f"{prefix}: chunk {key!r} is missing") from None
        if compressor is not None:
            raw = decompress(raw)
        if len(raw) != chunk_bytes:
            raise OrbaxFormatError(f"{key}: {len(raw)} bytes, a chunk of {chunks} {dtype} "
                                   f"has {chunk_bytes}")
        block = np.frombuffer(raw, np_dtype).reshape(chunks)
        where = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        out[where] = block[tuple(slice(0, w.stop - w.start) for w in where)]
    return out


def _insert(tree: dict, keys: list[dict], value) -> None:
    """Place `value` at `keys` in `tree`: dict keys make dicts, sequence
    indices make (sparse, for now) dicts of ints, turned into lists later."""
    node = tree
    for i, k in enumerate(keys):
        kind = k["key_type"]
        if kind not in (DICT_KEY, SEQUENCE_KEY):
            raise OrbaxFormatError(f"unknown key_type {kind} at {k['key']!r}")
        name = int(k["key"]) if kind == SEQUENCE_KEY else k["key"]
        if i == len(keys) - 1:
            node[name] = value
        else:
            node = node.setdefault(name, {})


def _lists(node):
    """Dicts keyed 0..n-1 by sequence indices become lists."""
    if not isinstance(node, dict):
        return node
    items = {k: _lists(v) for k, v in node.items()}
    if items and all(isinstance(k, int) for k in items):
        if sorted(items) != list(range(len(items))):
            raise OrbaxFormatError(f"sequence indices {sorted(items)} are not 0..n-1")
        return [items[i] for i in range(len(items))]
    return items


def read_orbax(directory: str) -> dict:
    """The array tree of an orbax checkpoint directory, as numpy: what
    `rift_tpu`'s `CheckpointManager.restore_raw` returns ({'step',
    'params', 'batch_stats', 'opt_state'} for a training state), with
    None leaves kept and sequences as lists."""
    with open(os.path.join(directory, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise OrbaxFormatError(f"{directory}: only OCDBT with zarr v2 is supported "
                               f"(use_ocdbt={meta.get('use_ocdbt')}, "
                               f"use_zarr3={meta.get('use_zarr3')})")
    store = OcdbtStore(directory)
    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        kind = entry["value_metadata"]["value_type"]
        if kind == "None":
            value = None
        elif kind == "jax.Array":
            value = read_zarr(store, ".".join(str(k["key"]) for k in keys))
        else:
            raise OrbaxFormatError(f"unsupported value_type {kind!r}")
        _insert(tree, keys, value)
    return _lists(tree)
