"""rift_tpu_torch's module-zoo twins against rift_tpu's on the same numpy
inputs: grid subsampling (host C++ built by g++ into the port's build
directory), the Frustum-PointNet corners and loss with their gradients,
`bilateral_knn` and `knn_select` in every combination, `scatter_mean` of
`ops.voxelize`, `models.pvcnn.global_lrf_basis`, the pair-hash and PLY/PCD
utilities (files byte-equal and read back across the packages), and the
profiling helpers."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.data.grid_subsample import grid_subsample as j_grid_subsample
from rift_tpu.models.pvcnn import global_lrf_basis as j_global_lrf_basis
from rift_tpu.ops.frustum import frustum_pointnet_loss as j_frustum_loss
from rift_tpu.ops.frustum import get_box_corners_3d as j_box_corners
from rift_tpu.ops.neighbors import bilateral_knn as j_bilateral_knn
from rift_tpu.ops.neighbors import knn_select as j_knn_select
from rift_tpu.ops.voxelize import scatter_mean as j_scatter_mean
from rift_tpu.train.profiling import StepTimer as JStepTimer
from rift_tpu.utils import pair_hash as j_pair_hash
from rift_tpu.utils import visualize as j_visualize
from rift_tpu_torch.data.grid_subsample import grid_subsample, library_path
from rift_tpu_torch.models.pvcnn import global_lrf_basis
from rift_tpu_torch.ops import frustum_pointnet_loss, get_box_corners_3d, scatter_mean
from rift_tpu_torch.ops.neighbors import bilateral_knn, knn_select
from rift_tpu_torch.train import StepTimer, annotate, trace
from rift_tpu_torch.utils import pair_hash, visualize
from test_module_zoo import _frustum_fixtures

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 functions of the same inputs in another order of operations.
F32_ATOL = 1e-5


def _np(tree):
    return {k: np.array(v) for k, v in tree.items()}


@pytest.mark.parametrize("parts", ["points", "labels", "features", "both"])
def test_grid_subsample_is_the_reference(rng, parts):
    pts = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    feats = rng.randn(3000, 5).astype(np.float32)
    labels = rng.randint(0, 7, 3000).astype(np.int32)
    kw = {"points": {}, "labels": {"labels": labels}, "features": {"features": feats},
          "both": {"features": feats, "labels": labels}}[parts]
    for dl in (0.1, 0.37):
        got = grid_subsample(pts, sample_dl=dl, **kw)
        want = j_grid_subsample(pts, sample_dl=dl, **kw)
        got, want = ((x,) if isinstance(x, np.ndarray) else x for x in (got, want))
        assert len(got) == len(want) == 1 + len(kw)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert os.path.dirname(library_path()) == os.path.join(ROOT, "rift_tpu_torch", "_build")
    assert os.path.isfile(library_path())


def test_grid_subsample_checks_its_inputs(rng):
    pts = rng.rand(10, 3).astype(np.float32)
    with pytest.raises(ValueError):
        grid_subsample(pts[:, :2])
    with pytest.raises(ValueError):
        grid_subsample(pts, sample_dl=0.0)
    with pytest.raises(ValueError):
        grid_subsample(pts, features=np.zeros((9, 2), np.float32))
    with pytest.raises(ValueError):
        grid_subsample(pts, labels=np.zeros(11, np.int32))


@pytest.mark.parametrize("flip", [False, True])
def test_box_corners_are_the_reference(rng, flip):
    centers = rng.randn(5, 3).astype(np.float32)
    headings = rng.uniform(-np.pi, np.pi, 5).astype(np.float32)
    sizes = (rng.rand(5, 3) + 0.5).astype(np.float32)
    got = get_box_corners_3d(*map(torch.from_numpy, (centers, headings, sizes)), with_flip=flip)
    want = j_box_corners(*map(jnp.asarray, (centers, headings, sizes)), with_flip=flip)
    got, want = (x if flip else (x,) for x in (got, want))
    for a, b in zip(got, want):
        assert a.shape == (5, 3, 8)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("perfect", [True, False])
def test_frustum_loss_and_its_gradients_are_the_reference(perfect):
    inputs, targets, bins, templates = _frustum_fixtures(np.random.RandomState(2),
                                                         perfect=perfect)
    got_in = {k: torch.tensor(v, requires_grad=True) for k, v in _np(inputs).items()}
    t_tg = {k: torch.from_numpy(v) for k, v in _np(targets).items()}
    t_bins, t_tmpl = torch.from_numpy(np.array(bins)), torch.from_numpy(np.array(templates))
    loss = frustum_pointnet_loss(got_in, t_tg, t_bins, t_tmpl)
    loss.backward()
    want, grads = jax.value_and_grad(lambda i: j_frustum_loss(i, targets, bins, templates))(
        inputs)
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5, abs=1e-6)
    for k, g in grads.items():
        # A zero error's norm has a NaN gradient in JAX (0/0) and the
        # subgradient 0 in torch: held where the reference's is finite.
        g, got = np.asarray(g), got_in[k].grad.numpy()
        finite = np.isfinite(g)
        assert np.isfinite(got).all() and (finite.all() or perfect), k
        scale = max(float(np.abs(g[finite]).max(initial=0.0)), 1.0)
        np.testing.assert_allclose(got[finite], g[finite], rtol=0, atol=1e-5 * scale, err_msg=k)


def test_bilateral_knn_and_every_knn_select_combination(rng):
    a = rng.randn(2, 48, 3).astype(np.float32)
    b = rng.randn(2, 40, 3).astype(np.float32)
    for k in (4, 50):  # 50 > 40 and 48: the farthest repeats
        got = bilateral_knn(torch.from_numpy(a), torch.from_numpy(b), k)
        want = j_bilateral_knn(jnp.asarray(a), jnp.asarray(b), k)
        for x, y in zip(got, want):
            assert x.shape == y.shape
        for x, y in zip(got[:2], want[:2]):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=F32_ATOL)
        for x, y in zip(got[2:], want[2:]):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    for bilateral in (True, False):
        for dist in (True, False):
            for index in (True, False):
                kw = dict(bilateral=bilateral, return_distance=dist, return_index=index)
                got = knn_select(torch.from_numpy(a), torch.from_numpy(b), 5, **kw)
                want = j_knn_select(jnp.asarray(a), jnp.asarray(b), 5, **kw)
                if want is None:
                    assert got is None
                    continue
                got, want = ((x,) if not isinstance(x, tuple) else x for x in (got, want))
                assert len(got) == len(want)
                for x, y in zip(got, want):
                    if x.dtype.is_floating_point:
                        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0,
                                                   atol=F32_ATOL)
                    else:
                        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_scatter_mean_and_its_gradient_are_the_reference(rng):
    feats = rng.randn(2, 60, 4).astype(np.float32)
    idx = rng.randint(0, 9, (2, 60))
    valid = rng.rand(2, 60) > 0.2
    w = rng.randn(2, 10, 4).astype(np.float32)
    for v in (None, valid):
        t = torch.tensor(feats, requires_grad=True)
        got = scatter_mean(t, torch.from_numpy(idx), 10,
                           None if v is None else torch.from_numpy(v))
        (got * torch.from_numpy(w)).sum().backward()

        def ref(f):
            return j_scatter_mean(f, jnp.asarray(idx), 10, None if v is None else jnp.asarray(v))

        grad = jax.grad(lambda f: jnp.sum(ref(f) * jnp.asarray(w)))(jnp.asarray(feats))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref(jnp.asarray(feats))),
                                   rtol=0, atol=F32_ATOL)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(grad), rtol=0, atol=F32_ATOL)


def test_global_lrf_basis_is_the_reference(rng):
    coords = rng.randn(3, 100, 3).astype(np.float32)
    coords -= coords.mean(1, keepdims=True)
    got = global_lrf_basis(torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_global_lrf_basis(jnp.asarray(coords))),
                               rtol=0, atol=F32_ATOL)


def test_pair_hash_is_the_reference(rng):
    src = rng.randint(0, 30, (200, 2))
    existing = np.concatenate([src[::3], rng.randint(0, 30, (40, 2))])
    wide = rng.randint(0, 1000, (50, 5))
    np.testing.assert_array_equal(pair_hash.hash_rows(wide, 1_000_003),
                                  j_pair_hash.hash_rows(wide, 1_000_003))
    np.testing.assert_array_equal(pair_hash.hash_pairs(src[:, 0], src[:, 1]),
                                  j_pair_hash.hash_pairs(src[:, 0], src[:, 1]))
    np.testing.assert_array_equal(pair_hash.find_row(src[7], src),
                                  j_pair_hash.find_row(src[7], src))
    got = pair_hash.filter_intersection(src, existing)
    np.testing.assert_array_equal(got, j_pair_hash.filter_intersection(src, existing))
    assert not any(len(pair_hash.find_row(r, existing)) for r in got)
    assert pair_hash.filter_intersection(src, existing[:0]) is src


def test_ply_files_are_byte_equal_and_read_back_across_packages(tmp_path, rng):
    src = rng.randn(20, 3).astype(np.float32)
    dst = rng.randn(25, 3).astype(np.float32)
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = 0.5
    idx1, idx2 = rng.randint(0, 20, 12), rng.randint(0, 25, 12)
    writes = [("pcd", lambda m, p: m.save_pcd_ply(p, src)),
              ("pcd_colors", lambda m, p: m.save_pcd_ply(
                  p, src, colors=rng_colors)),
              ("registration", lambda m, p: m.save_registration_ply(p, src, dst, t)),
              ("corr", lambda m, p: m.save_correspondences_ply(p, src, dst, idx1, idx2,
                                                               mask=idx1 % 2 == 0))]
    rng_colors = rng.randint(0, 256, (20, 3)).astype(np.uint8)
    for name, write in writes:
        mine, theirs = tmp_path / f"{name}_port.ply", tmp_path / f"{name}_ref.ply"
        write(visualize, str(mine))
        write(j_visualize, str(theirs))
        assert mine.read_bytes() == theirs.read_bytes(), name
        for reader in (visualize, j_visualize):
            for path in (mine, theirs):
                pts, colors = reader.read_pcd_ply(str(path))
                want_pts, want_colors = j_visualize.read_pcd_ply(str(theirs))
                np.testing.assert_array_equal(pts, want_pts)
                if want_colors is None:
                    assert colors is None
                else:
                    np.testing.assert_array_equal(colors, want_colors)
    assert (visualize.FRAG1_COLOR, visualize.FRAG2_COLOR, visualize.KEYPOINT_COLOR,
            visualize.LINE_COLOR) == (j_visualize.FRAG1_COLOR, j_visualize.FRAG2_COLOR,
                                      j_visualize.KEYPOINT_COLOR, j_visualize.LINE_COLOR)


def test_binary_ply_and_ascii_pcd_read_as_the_reference(tmp_path, rng):
    pts = rng.randn(9, 3).astype(np.float32)
    cols = rng.randint(0, 256, (9, 3)).astype(np.uint8)
    rec = np.empty(9, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"),
                             ("green", "u1"), ("blue", "u1")])
    for i, k in enumerate("xyz"):
        rec[k] = pts[:, i]
    rec["red"], rec["green"], rec["blue"] = cols.T
    ply = tmp_path / "b.ply"
    ply.write_bytes(b"ply\nformat binary_little_endian 1.0\nelement vertex 9\n"
                    + b"".join(f"property {t} {n}\n".encode() for t, n in (
                        ("float", "x"), ("float", "y"), ("float", "z"), ("uchar", "red"),
                        ("uchar", "green"), ("uchar", "blue")))
                    + b"end_header\n" + rec.tobytes())
    packed = ((cols[:, 0].astype(np.uint32) << 16) | (cols[:, 1].astype(np.uint32) << 8)
              | cols[:, 2]).view(np.float32)
    pcd = tmp_path / "a.pcd"
    pcd.write_text("# .PCD v0.7\nVERSION 0.7\nFIELDS x y z rgb\nSIZE 4 4 4 4\nTYPE F F F F\n"
                   "COUNT 1 1 1 1\nWIDTH 9\nHEIGHT 1\nPOINTS 9\nDATA ascii\n"
                   + "".join(f"{p[0]:.9g} {p[1]:.9g} {p[2]:.9g} {c:.9g}\n"
                             for p, c in zip(pts, packed)))
    for path in (ply, pcd):
        got, want = visualize.read_pcd_ply(str(path)), j_visualize.read_pcd_ply(str(path))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(visualize.read_pcd_ply(str(ply))[1], cols)


def test_trace_writes_a_trace_with_the_annotated_range(tmp_path):
    x = torch.randn(64, 64)
    with trace(str(tmp_path / "log")) as prof:
        with annotate("rift_probe_range"):
            (x @ x).sum()
    text = (tmp_path / "log" / "trace.json").read_text()
    assert "rift_probe_range" in text
    assert any(e.name == "rift_probe_range" for e in prof.events())


def test_step_timer_drops_its_warmup_as_the_reference():
    for timer in (StepTimer(warmup=2), JStepTimer(warmup=2)):
        assert timer.summary() == {"mean_s": 0.0, "min_s": 0.0, "count": 0}
        for _ in range(5):
            with timer.measure():
                sum(range(1000))
        assert len(timer.times) == 3 and timer.summary()["count"] == 3
        assert timer.summary()["min_s"] <= timer.mean()
    timer, out = StepTimer(warmup=0), {}
    with timer.measure(out):  # the result filled in by the block
        out["y"] = torch.ones(3) * 2
    assert len(timer.times) == 1
