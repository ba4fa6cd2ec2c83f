"""A read-only OCDBT key-value store: the on-disk B-tree that orbax writes
through tensorstore (`use_ocdbt`), read with numpy and the port's own
zstd decoder (`utils.zstd`), on a machine that has neither.

Layout of a store rooted at a directory:

- `manifest.ocdbt`: a header (magic 0x0cdb3a2a, total length as uint64le,
  format version and compression as varints), a body (zstd when the
  compression is 1) and a CRC-32C footer. The body holds the config (uuid,
  manifest kind, inline-value and node limits, version-tree arity, node
  compression) and the version tree's inline leaf: the newest versions,
  each with its root node reference.
- B-tree nodes (magic 0x0cdb20de, same header and footer) at
  (file, offset, length) in a data file. A node holds its height, a table
  of data-file paths (prefix-compressed, relative to the store's root) and
  its entries: a leaf maps keys to values that are inline or that name a
  data file, offset and length; an interior node maps each child's first
  key (and the prefix every key below it shares, stripped from the child's
  own keys) to the child's node reference.

Arrays of a node are stored column by column: all prefix lengths, then all
suffix lengths, then the suffix bytes, and so on.
"""
from __future__ import annotations

import os
import struct

import numpy as np

from ..utils.zstd import decompress

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE


def _crc32c_table() -> np.ndarray:
    table = np.zeros(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table[i] = c
    return table


_CRC_TABLE = _crc32c_table().tolist()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class OcdbtError(ValueError):
    """A file that is not the OCDBT format this reader knows."""


class _Reader:
    """Cursor over a decoded body, for errors naming what was read."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def fail(self, message: str):
        raise OcdbtError(f"{self.what}: {message} at byte {self.pos}")

    def varint(self) -> int:
        value, shift, data = 0, 0, self.data
        while True:
            if self.pos >= len(data):
                self.fail("varint runs past the end")
            byte = data[self.pos]
            self.pos += 1
            value |= (byte & 0x7F) << shift
            if byte < 0x80:
                return value
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            self.fail(f"{n} bytes run past the end")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def end(self) -> None:
        if self.pos != len(self.data):
            self.fail(f"{len(self.data) - self.pos} bytes left over")


def _prefixed(r: _Reader, n: int, prefix_lengths: list[int], suffix_lengths: list[int]
              ) -> list[bytes]:
    """n byte strings, each the first prefix_lengths[i - 1] bytes of the one
    before it followed by its own suffix bytes."""
    out, prev = [], b""
    for i in range(n):
        keep = prefix_lengths[i - 1] if i else 0
        if keep > len(prev):
            r.fail("key prefix longer than the key before it")
        prev = prev[:keep] + r.take(suffix_lengths[i])
        out.append(prev)
    return out


def _data_file_table(r: _Reader) -> list[str]:
    n = r.varint()
    if n == 0:
        return []
    prefix, suffix = r.varints(n - 1), r.varints(n)
    base = r.varints(n)
    paths = _prefixed(r, n, prefix, suffix)
    for path, b in zip(paths, base):
        if b > len(path):
            r.fail("base path longer than its path")
    return [p.decode() for p in paths]


def _refs(r: _Reader, n: int, files: list[str]) -> list[tuple[str, int, int]]:
    """n data references: file ids, then offsets, then lengths."""
    ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
    for i in ids:
        if i >= len(files):
            r.fail(f"data file id {i} of a table of {len(files)}")
    return [(files[i], o, n_) for i, o, n_ in zip(ids, offsets, lengths)]


class OcdbtStore:
    """The newest version of the OCDBT store at `root` (a directory):
    `list()` of its keys in order, and `read(key)` of a value's bytes."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._files: dict[str, bytes] = {}
        self.config, self.root_ref, self.root_height = self._manifest()
        self._entries: dict[bytes, tuple] | None = None

    def _file(self, rel: str) -> bytes:
        data = self._files.get(rel)
        if data is None:
            path = os.path.normpath(os.path.join(self.root, rel))
            if os.path.commonpath([path, self.root]) != self.root:
                raise OcdbtError(f"data file {rel!r} lies outside {self.root}")
            with open(path, "rb") as f:
                data = f.read()
            self._files[rel] = data
        return data

    @staticmethod
    def _unwrap(raw: bytes, magic: int, what: str) -> bytes:
        """The body of a manifest or node: header, (zstd) body, CRC-32C."""
        if len(raw) < 18:
            raise OcdbtError(f"{what}: {len(raw)} bytes, shorter than a header")
        got_magic, length = struct.unpack_from(">I", raw, 0)[0], struct.unpack_from("<Q", raw, 4)[0]
        if got_magic != magic:
            raise OcdbtError(f"{what}: magic {got_magic:#010x}, expected {magic:#010x}")
        if length != len(raw):
            raise OcdbtError(f"{what}: header says {length} bytes, found {len(raw)}")
        want = struct.unpack_from("<I", raw, len(raw) - 4)[0]
        if crc32c(raw[:-4]) != want:
            raise OcdbtError(f"{what}: CRC-32C mismatch")
        r = _Reader(raw, what)
        r.pos = 12
        if r.varint() != 0:
            r.fail("unknown format version")
        compression = r.varint()
        body = raw[r.pos:-4]
        if compression == 0:
            return body
        if compression == 1:
            return decompress(body)
        r.fail(f"unknown compression {compression}")

    def _manifest(self):
        r = _Reader(self._unwrap(self._file("manifest.ocdbt"), MANIFEST_MAGIC, "manifest"),
                    "manifest")
        config = {"uuid": r.take(16).hex(), "manifest_kind": r.varint(),
                  "max_inline_value_bytes": r.varint(), "max_decoded_node_bytes": r.varint(),
                  "version_tree_arity_log2": r.u8(), "compression": r.varint()}
        if config["compression"] == 1:
            config["zstd_level"] = struct.unpack("<i", r.take(4))[0]
        elif config["compression"] != 0:
            r.fail(f"unknown node compression {config['compression']}")
        if config["manifest_kind"] != 0:
            r.fail("numbered manifests are not supported")
        files = _data_file_table(r)
        n = r.varint()
        if n == 0:
            r.fail("no version in the manifest")
        generations = r.varints(n)
        heights = [r.u8() for _ in range(n)]
        roots = _refs(r, n, files)
        r.varints(3 * n)  # per version: keys, tree bytes, indirect value bytes
        r.take(8 * n)  # commit times
        newest = int(np.argmax(generations))
        # The rest references older versions' tree nodes, which are not read.
        return config, roots[newest], heights[newest]

    def _node(self, ref: tuple[str, int, int], height: int, prefix: bytes,
              out: dict[bytes, tuple]) -> None:
        rel, offset, length = ref
        data = self._file(rel)
        if offset + length > len(data):
            raise OcdbtError(f"node {ref} runs past the end of {rel}")
        what = f"node {rel}@{offset}"
        r = _Reader(self._unwrap(data[offset:offset + length], NODE_MAGIC, what), what)
        if r.u8() != height:
            r.fail(f"height differs from its reference's {height}")
        files = _data_file_table(r)
        n = r.varint()
        key_prefix, key_suffix = r.varints(n - 1) if n else [], r.varints(n)
        if height == 0:
            keys = _prefixed(r, n, key_prefix, key_suffix)
            lengths = r.varints(n)
            kinds = [r.u8() for _ in range(n)]
            if any(k > 1 for k in kinds):
                r.fail("unknown value kind")
            m = sum(kinds)
            ids, offsets = r.varints(m), r.varints(m)
            indirect = iter(zip(ids, offsets))
            for key, kind, size in zip(keys, kinds, lengths):
                if kind == 1:
                    fid, off = next(indirect)
                    if fid >= len(files):
                        r.fail(f"data file id {fid} of a table of {len(files)}")
                    out[prefix + key] = ("file", files[fid], off, size)
            for key, kind, size in zip(keys, kinds, lengths):
                if kind == 0:
                    out[prefix + key] = ("inline", r.take(size))
            r.end()
            return
        common = r.varints(n)
        keys = _prefixed(r, n, key_prefix, key_suffix)
        children = _refs(r, n, files)
        r.varints(3 * n)  # per child: keys, tree bytes, indirect value bytes
        r.end()
        for key, c, child in zip(keys, common, children):
            if c > len(key):
                r.fail("subtree prefix longer than its key")
            self._node(child, height - 1, prefix + key[:c], out)

    def _index(self) -> dict[bytes, tuple]:
        if self._entries is None:
            entries: dict[bytes, tuple] = {}
            self._node(self.root_ref, self.root_height, b"", entries)
            self._entries = entries
        return self._entries

    def list(self) -> list[bytes]:
        """Every key of the newest version, in byte order."""
        return sorted(self._index())

    def read(self, key: bytes | str) -> bytes:
        """The value of `key`; KeyError when there is none."""
        if isinstance(key, str):
            key = key.encode()
        entry = self._index()[key]
        if entry[0] == "inline":
            return entry[1]
        _, rel, offset, size = entry
        data = self._file(rel)
        if offset + size > len(data):
            raise OcdbtError(f"value of {key!r} runs past the end of {rel}")
        return data[offset:offset + size]
