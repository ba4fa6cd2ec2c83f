"""The port's reader of the reference's orbax checkpoints against the tools
that wrote them: the zstd decoder (`utils/zstd.py`, host C++) against
`zstandard`, the OCDBT store (`train/ocdbt.py`) against tensorstore's
kvstore on every committed directory and on trees with interior nodes,
zarr v2 arrays against tensorstore's zarr driver, and `read_orbax` against
`rift_tpu`'s `CheckpointManager.restore_raw`, bit for bit; the sha256
constant of chip_smoke.py's trained phase against orbax's own arrays."""
import glob
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import tensorstore as ts
import torch
import zstandard

from rift_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints
from rift_tpu_torch.train.checkpoint import CheckpointManager
from rift_tpu_torch.train.loop import load_trained_state
from rift_tpu_torch.train.ocdbt import OcdbtStore
from rift_tpu_torch.train.orbax_read import OrbaxFormatError, read_orbax, read_zarr
from rift_tpu_torch.utils import zstd
from rift_tpu_torch.weights import from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints")
FLAGSHIP = os.path.join(CKPT, "mn40_sph_pt_r4", "best_acc")
ORBAX_DIRS = sorted(os.path.relpath(os.path.dirname(p), CKPT)
                    for p in glob.glob(os.path.join(CKPT, "**", "manifest.ocdbt"), recursive=True)
                    if "ocdbt.process_" not in p)
RESTORED = [("mn40_sph_pt_r4", "best_acc"), ("shapenet_r3", "best_iou"),
            ("rank_mn40_cu_dg", "best_acc"), (".", "best_acc")]
ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def _zstandard(data: bytes) -> bytes:
    """Every frame of `data` through zstandard (frames without a content
    size included)."""
    out = []
    while data:
        obj = zstandard.ZstdDecompressor().decompressobj()
        out.append(obj.decompress(data))
        data = obj.unused_data
    return b"".join(out)


def _inputs():
    rng = np.random.RandomState(0)
    return {"floats_300k": rng.randn(75_000).astype(np.float32).tobytes(),  # several blocks
            "rle": bytes(200_000) + b"ab" * 50_000 + bytes(1000),
            "incompressible": rng.bytes(150_000),
            "small_ints": rng.randint(0, 4, 60_000).astype(np.uint8).tobytes(),
            "text": b"the committed runs of the reference, read on the card's host\n" * 40,
            "one_byte": b"x"}


def test_zstd_matches_zstandard_on_every_frame_of_the_flagship():
    """The root manifest's and B-tree node's bodies and every value that is
    a zstd frame (each array chunk) of the flagship's best_acc."""
    store = OcdbtStore(FLAGSHIP)
    bodies = []
    for name in ["manifest.ocdbt"] + [os.path.join("d", f) for f in os.listdir(
            os.path.join(FLAGSHIP, "d"))]:
        with open(os.path.join(FLAGSHIP, name), "rb") as f:
            raw = f.read()
        assert raw[13] == 1 and raw[14:18] == ZSTD_MAGIC  # a zstd body after the header
        bodies.append(raw[14:-4])
    chunks = [v for v in map(store.read, store.list()) if v[:4] == ZSTD_MAGIC]
    assert len(chunks) == 195
    assert all(c[4] == 0x00 for c in chunks)  # no checksum, no content size
    for frame in bodies + chunks:
        assert zstd.decompress(frame) == _zstandard(frame)


@pytest.mark.parametrize("content_size", [False, True])
@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("level", [1, 3, 19])
def test_zstd_matches_zstandard_on_synthetic_frames(level, checksum, content_size):
    cctx = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                    write_content_size=content_size)
    for name, data in _inputs().items():
        frame = cctx.compress(data)
        assert zstd.decompress(frame) == data, name


def test_zstd_reads_concatenated_and_skippable_frames():
    data = _inputs()
    a = zstandard.ZstdCompressor(level=3).compress(data["floats_300k"])
    b = zstandard.ZstdCompressor(level=1, write_checksum=True).compress(data["text"])
    skip = b"\x5a\x2a\x4d\x18" + (5).to_bytes(4, "little") + b"hello"
    assert zstd.decompress(a + b) == data["floats_300k"] + data["text"]
    assert zstd.decompress(skip + b + skip + a) == data["text"] + data["floats_300k"]


@pytest.mark.parametrize("where", ["reserved_bit", "block", "checksum", "truncated"])
def test_zstd_corrupted_input_raises_with_the_offset(where):
    data = _inputs()["floats_300k"]
    frame = bytearray(zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data))
    if where == "reserved_bit":
        frame[4] |= 0x08
    elif where == "block":
        frame[len(frame) // 2] ^= 0x5A
    elif where == "checksum":
        frame[-1] ^= 0x01
    else:
        frame = frame[:-100]
    with pytest.raises(zstd.ZstdError, match=r"at byte \d+"):
        zstd.decompress(bytes(frame))
    with pytest.raises(zstd.ZstdError, match="bad magic"):
        zstd.decompress(b"not zstd")


def test_zstd_dictionary_frame_raises():
    samples = [bytes([i % 7]) * 40 + b"shared dictionary text %d" % i for i in range(400)]
    dictionary = zstandard.train_dictionary(2048, samples)
    frame = zstandard.ZstdCompressor(dict_data=dictionary).compress(samples[3] * 4)
    with pytest.raises(zstd.ZstdError, match="dictionary"):
        zstd.decompress(frame)


@pytest.mark.parametrize("directory", ORBAX_DIRS)
def test_ocdbt_matches_tensorstore_kvstore(directory):
    path = os.path.join(CKPT, directory)
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/"}).result()
    keys = kv.list().result()
    store = OcdbtStore(path)
    assert store.list() == list(keys) and len(keys) > 250
    for key in keys:
        assert store.read(key) == kv.read(key).result().value, key


@pytest.mark.parametrize("compression", ["zstd", None])
def test_ocdbt_reads_interior_nodes_that_tensorstore_wrote(tmp_path, compression):
    """A tree of height > 0 (small nodes), with inline and indirect values
    and a second version, as tensorstore writes it."""
    config = {"max_decoded_node_bytes": 600, "max_inline_value_bytes": 50}
    if compression:
        config["compression"] = {"id": compression}
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": config}).result()
    rng = np.random.RandomState(1)
    want = {f"group{i % 7}/sub{i % 13}/item{i:05d}".encode(): rng.bytes(int(rng.randint(0, 120)))
            for i in range(400)}
    with ts.Transaction() as txn:
        for key, value in want.items():
            kv.with_transaction(txn)[key] = value
    kv.write(b"later", b"x" * 70).result()
    want[b"later"] = b"x" * 70
    store = OcdbtStore(str(tmp_path))
    assert store.root_height > 0
    assert store.list() == sorted(want)
    assert all(store.read(k) == v for k, v in want.items())
    with pytest.raises(KeyError):
        store.read(b"absent")


def test_read_zarr_matches_tensorstore_on_a_chunk_grid(tmp_path):
    """Edge chunks, several dtypes, a 0-d array; a missing chunk raises."""
    base = {"driver": "ocdbt", "base": f"file://{tmp_path}/"}
    rng = np.random.RandomState(2)
    arrays = {"a.f32": rng.randn(7, 9).astype("<f4"), "b.i32": rng.randint(-9, 9, (5, 3, 4),
                                                                               dtype="<i4"),
              "c.f64": np.asarray(3.25, "<f8")}
    chunks = {"a.f32": [3, 4], "b.i32": [2, 3, 3], "c.f64": []}
    for name, value in arrays.items():
        arr = ts.open({"driver": "zarr", "kvstore": dict(base, path=f"{name}/"),
                       "metadata": {"shape": list(value.shape), "chunks": chunks[name],
                                    "dtype": value.dtype.str,
                                    "compressor": {"id": "zstd", "level": 1}},
                       "create": True}).result()
        arr.write(value).result()
    partial = ts.open({"driver": "zarr", "kvstore": dict(base, path="d.f32/"),
                       "metadata": {"shape": [6], "chunks": [2], "dtype": "<f4",
                                    "compressor": None, "fill_value": None},
                       "create": True}).result()
    partial[:2].write(np.ones(2, np.float32)).result()
    store = OcdbtStore(str(tmp_path))
    for name, value in arrays.items():
        got = read_zarr(store, name)
        assert got.dtype == value.dtype and got.shape == value.shape
        assert got.tobytes() == value.tobytes(), name
    with pytest.raises(OrbaxFormatError, match="missing"):
        read_zarr(store, "d.f32")


class _Store:
    def __init__(self, meta, chunk):
        self.values = {"x/.zarray": json.dumps(meta).encode(), "x/0": chunk}

    def read(self, key):
        return self.values[key]


@pytest.mark.parametrize("field, value, match", [
    ("dtype", "<c8", "dtype"), ("dtype", "bfloat16", "dtype"),
    ("compressor", {"id": "blosc"}, "compressor"), ("order", "F", "order"),
    ("filters", [{"id": "delta"}], "filters")])
def test_read_zarr_raises_on_what_it_does_not_know(field, value, match):
    meta = {"zarr_format": 2, "shape": [2], "chunks": [2], "dtype": "<f4",
            "compressor": None, "filters": None, "order": "C", "fill_value": None}
    meta[field] = value
    with pytest.raises(OrbaxFormatError, match=match):
        read_zarr(_Store(meta, bytes(8)), "x")


def _same_tree(got, want, path="root"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f"{path}/{i}")
    elif want is None:
        assert got is None, path
    else:
        assert type(got) is np.ndarray and type(want) is np.ndarray, path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path


@pytest.mark.parametrize("run, name", RESTORED)
def test_read_orbax_equals_restore_raw_bit_for_bit(run, name):
    want = JaxCheckpoints(os.path.join(CKPT, run)).restore_raw(name)
    got = read_orbax(os.path.join(CKPT, run, name))
    assert set(got) == {"step", "params", "batch_stats", "opt_state"}
    _same_tree(got, want)
    assert CheckpointManager(os.path.join(CKPT, run)).restore_raw(name).keys() == got.keys()


def test_chip_smoke_trained_sha256_is_that_of_orbax_arrays():
    """chip_smoke.py's TRAINED_SHA256 is state_sha256 of the flagship's
    state dict converted from orbax's own restore, and the port's reader
    gives the same state dict."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    raw = JaxCheckpoints(os.path.dirname(FLAGSHIP)).restore_raw("best_acc")
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    state = from_flax(to_np(raw["params"]), to_np(raw["batch_stats"]))
    assert chip_smoke.state_sha256(state) == chip_smoke.TRAINED_SHA256
    ours, _ = load_trained_state(os.path.dirname(FLAGSHIP), "best_acc")
    assert chip_smoke.state_sha256(ours["model"]) == chip_smoke.TRAINED_SHA256
    assert ours["step"] == int(raw["step"])
    assert chip_smoke.TRAINED_RUNS["flagship"][0] == "mn40_sph_pt_r4"
