"""The plain PyTorch versions of the port's kernels (K1 normals moments, K2
voxel scatter-mean, K3 corner gather, K4 corner scatter, K5 bf16 Conv3d)
against the Pallas kernels they replace, run in interpret mode on the CPU as
tests/test_pallas_ops.py runs them, and the autograd Functions built on K2,
K3 and K4. On a CPU tensor each wrapper takes the plain version, so these
also cover the wrappers' CPU route."""
import glob
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.ops.pallas import corner_gather_pallas, scatter_mean_pallas
from rift_tpu.ops.pallas.normals_kernel import neighborhood_moments_pallas
from rift_tpu.ops.pallas.onehot_ops import corner_scatter_pallas
from rift_tpu_torch.ops.cuda import (conv3d_same, corner_gather, corner_scatter,
                                     neighborhood_moments, scatter_mean)
from rift_tpu_torch.ops.cuda import conv3d as conv3d_module
from rift_tpu_torch.ops.cuda import normals_kernel as normals_module
from rift_tpu_torch.ops.cuda import onehot_ops as onehot_module
from rift_tpu_torch.ops.cuda.conv3d import conv3d_same_plain, padded_bf16
from rift_tpu_torch.ops.cuda.normals_kernel import neighborhood_moments_plain, point_sqdist
from rift_tpu_torch.ops.cuda.onehot_ops import (corner_gather_plain, corner_scatter_plain,
                                                scatter_mean_plain)
from rift_tpu_torch.ops.voxel_autograd import CornerGather, ScatterMean

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _conv3d_experiment():
    """scripts/conv3d_kernel_experiment.py, the module of K5's Pallas kernel
    (scripts/ is not a package)."""
    path = os.path.join(ROOT, "scripts", "conv3d_kernel_experiment.py")
    spec = importlib.util.spec_from_file_location("conv3d_kernel_experiment", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def bf16_ulp(a):
    """The spacing of bf16 numbers (8 significant bits) at |a|, as f64."""
    _, e = np.frexp(np.abs(np.asarray(a, np.float64)))
    return np.ldexp(1.0, e - 8)


def _cloud(rng, b, n, duplicates):
    pts = rng.uniform(-1.0, 1.0, (b, n, 3)).astype(np.float32)
    if duplicates:
        # 20 coincident copies of one point (>= k at distance 0: the empty
        # bracket rule) and a tight cluster.
        pts[:, 1:21] = pts[:, :1]
        pts[:, 40:60] = pts[:, 40:41] + 1e-4 * rng.randn(b, 20, 3).astype(np.float32)
    return pts


@pytest.mark.parametrize("k,duplicates", [(16, False), (16, True), (0, False)])
def test_moments_plain_matches_pallas(rng, k, duplicates):
    pts = _cloud(rng, 2, 256, duplicates)
    r2 = 0.01
    s1_j, s2_j, cnt_j = (np.asarray(a) for a in neighborhood_moments_pallas(
        jnp.asarray(pts), k, r2, tile=128, interpret=True))
    s1, s2, cnt = (a.numpy() for a in neighborhood_moments(torch.from_numpy(pts), k, r2))
    # JAX forms a·t by an f32 matmul, the port by the kernel's unfused
    # component sums: d² may differ by an ulp, which can move a point across
    # the radius. Bound the share of queries whose neighbour count differs.
    same = cnt == cnt_j
    assert same.mean() >= 0.99, same.mean()
    # Where the sets agree the moments are the same sums in another order.
    np.testing.assert_allclose(s1[same], s1_j[same], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s2[same], s2_j[same], rtol=1e-5, atol=1e-5)
    if duplicates:
        assert np.all(cnt[:, 0] >= 21)  # the coincident copies are neighbours


def test_point_sqdist_is_the_kernel_expansion(rng):
    q = rng.randn(1, 7, 3).astype(np.float32)
    p = rng.randn(1, 9, 3).astype(np.float32)
    want = np.zeros((1, 7, 9), np.float32)
    for i in range(7):
        for j in range(9):
            a, t = q[0, i], p[0, j]
            q2 = np.float32(np.float32(a[0] * a[0]) + np.float32(a[1] * a[1])) + np.float32(a[2] * a[2])
            p2 = np.float32(np.float32(t[0] * t[0]) + np.float32(t[1] * t[1])) + np.float32(t[2] * t[2])
            cross = np.float32(np.float32(a[0] * t[0]) + np.float32(a[1] * t[1])) + np.float32(a[2] * t[2])
            want[0, i, j] = max(np.float32(np.float32(q2 + p2) - np.float32(2 * cross)), 0)
    got = point_sqdist(torch.from_numpy(q), torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, want)


def test_scatter_mean_plain_matches_pallas(rng):
    b, n, c, s = 2, 128, 16, 64
    feat = rng.randn(b, n, c).astype(np.float32)
    inds = rng.randint(-1, s, (b, n)).astype(np.int32)
    inds[:, :10] = 5  # a crowded voxel
    inds[inds == 7] = 8  # voxel 7 stays empty
    out_j, cnt_j = scatter_mean_pallas(jnp.asarray(feat), jnp.asarray(inds), s, tile=32)
    out, cnt = scatter_mean(torch.from_numpy(feat), torch.from_numpy(inds), s)
    # Both sum each voxel's points then scale by 1/count, in another order.
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))
    assert np.all(out.numpy()[:, 7] == 0) and np.all(cnt.numpy()[:, 7] == 0)
    assert cnt.numpy().sum() == (inds >= 0).sum()


def test_corner_gather_plain_matches_pallas(rng):
    b, n, c, s = 2, 64, 8, 128
    grid = rng.randn(b, s, c).astype(np.float32)
    idx = rng.randint(0, s, (b, n, 8)).astype(np.int32)
    idx[0, 3] = -1  # an undefined point
    idx[1, 5, :4] = -1  # skipped corners with nonzero weight
    w = rng.rand(b, n, 8).astype(np.float32)
    want = np.asarray(corner_gather_pallas(jnp.asarray(grid), jnp.asarray(idx),
                                           jnp.asarray(w), tile=32))
    got = corner_gather(torch.from_numpy(grid), torch.from_numpy(idx),
                        torch.from_numpy(w)).numpy()
    # Eight products summed in another order (the Pallas kernel contracts
    # a one-hot matrix tile by tile).
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.all(got[0, 3] == 0)


def _corners(rng, b, n, s):
    idx = rng.randint(0, s, (b, n, 8)).astype(np.int32)
    idx[0, 3] = -1  # an undefined point
    idx[1, 5, :4] = -1  # skipped corners with nonzero weight
    idx[0, 7:12] = idx[0, 6]  # points sharing all their corners
    w = rng.rand(b, n, 8).astype(np.float32)
    return idx, w


def test_corner_scatter_plain_matches_pallas_and_is_the_adjoint(rng):
    b, n, c, s = 2, 64, 8, 128
    idx, w = _corners(rng, b, n, s)
    dout = rng.randn(b, n, c).astype(np.float32)
    want = np.asarray(corner_scatter_pallas(jnp.asarray(dout), jnp.asarray(idx),
                                            jnp.asarray(w), s, tile=32))
    got = corner_scatter(torch.from_numpy(dout), torch.from_numpy(idx),
                         torch.from_numpy(w), s)
    # The Pallas kernel contracts a one-hot weight matrix with dout tile by
    # tile; the plain version sums the same products in (p, k) order.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert got.shape == (b, s, c)
    untouched = np.ones((b, s), bool)
    for bi in range(b):
        untouched[bi, idx[bi][idx[bi] >= 0]] = False
    assert untouched.any() and np.all(got.numpy()[untouched] == 0)
    # <K4(dout), grid> == <dout, K3(grid)>, with the port's K3.
    grid = torch.from_numpy(rng.randn(b, s, c).astype(np.float32)).double()
    lhs = float((got.double() * grid).sum())
    rhs = float((torch.from_numpy(dout).double()
                 * corner_gather_plain(grid, torch.from_numpy(idx),
                                       torch.from_numpy(w).double())).sum())
    np.testing.assert_allclose(lhs, rhs, rtol=1e-6)


def test_autograd_functions_pass_gradcheck(rng):
    b, n, c, s = 2, 12, 3, 10
    feat = torch.from_numpy(rng.randn(b, n, c)).requires_grad_()
    inds = torch.from_numpy(rng.randint(-1, s, (b, n)))
    assert torch.autograd.gradcheck(lambda f: ScatterMean.apply(f, inds, s)[0], (feat,))
    grid = torch.from_numpy(rng.randn(b, s, c)).requires_grad_()
    idx, w = _corners(rng, b, n, s)
    assert torch.autograd.gradcheck(
        lambda g: CornerGather.apply(g, torch.from_numpy(idx), torch.from_numpy(w).double()),
        (grid,))


def test_wrappers_take_plain_version_on_cpu_and_count_no_launch(rng):
    pts = torch.from_numpy(_cloud(rng, 1, 64, False))
    before = (neighborhood_moments.launches, scatter_mean.launches, corner_gather.launches,
              corner_scatter.launches)
    for a, b in zip(neighborhood_moments(pts, 8, 0.01), neighborhood_moments_plain(pts, 8, 0.01)):
        assert torch.equal(a, b)
    feat = torch.randn(1, 64, 4)
    inds = torch.randint(-1, 16, (1, 64))
    assert all(torch.equal(a, b) for a, b in
               zip(scatter_mean(feat, inds, 16), scatter_mean_plain(feat, inds, 16)))
    grid = torch.randn(1, 16, 4)
    idx = torch.randint(-1, 16, (1, 64, 8))
    w = torch.rand(1, 64, 8)
    assert torch.equal(corner_gather(grid, idx, w), corner_gather_plain(grid, idx, w))
    dout = torch.randn(1, 64, 4)
    assert torch.equal(corner_scatter(dout, idx, w, 16), corner_scatter_plain(dout, idx, w, 16))
    assert before == (neighborhood_moments.launches, scatter_mean.launches,
                      corner_gather.launches, corner_scatter.launches)


@pytest.mark.parametrize("kernel", ["scatter_mean", "corner_gather", "corner_scatter"])
def test_indices_at_or_past_s_are_dropped_as_by_pallas(rng, kernel):
    """An index >= s matches no voxel in the one-hot kernels, as -1 does:
    it must not reach the next cloud's voxels (b = 2, s = 8; indices s and
    s + 1 in cloud 0)."""
    b, n, c, s = 2, 16, 4, 8
    feat = rng.randn(b, n, c).astype(np.float32)
    if kernel == "scatter_mean":
        inds = rng.randint(1, s, (b, n)).astype(np.int32)
        inds[0, :2] = [s, s + 1]
        want, want_cnt = (np.asarray(a) for a in scatter_mean_pallas(
            jnp.asarray(feat), jnp.asarray(inds), s, tile=8))
        got, cnt = (a.numpy() for a in scatter_mean(torch.from_numpy(feat),
                                                    torch.from_numpy(inds), s))
        np.testing.assert_array_equal(cnt, want_cnt)
        assert cnt[1, 0] == 0 and cnt.sum() == b * n - 2
        # Sums of the same points in another order.
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        return
    idx = rng.randint(1, s, (b, n, 8)).astype(np.int32)
    idx[0, 0, :2] = [s, s + 1]
    idx[0, 1, :] = s + 1
    w = rng.rand(b, n, 8).astype(np.float32)
    if kernel == "corner_gather":
        grid = rng.randn(b, s, c).astype(np.float32)
        want = np.asarray(corner_gather_pallas(jnp.asarray(grid), jnp.asarray(idx),
                                               jnp.asarray(w), tile=8))
        got = corner_gather(*map(torch.from_numpy, (grid, idx, w))).numpy()
        assert np.all(got[0, 1] == 0)  # every corner out of range: an output of 0
    else:
        want = np.asarray(corner_scatter_pallas(jnp.asarray(feat), jnp.asarray(idx),
                                                jnp.asarray(w), s, tile=8))
        got = corner_scatter(*map(torch.from_numpy, (feat, idx, w)), s).numpy()
        assert np.all(got[1, 0] == 0)  # cloud 1 never names voxel 0
    # Eight weighted rows summed in another order.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bf16_scatter_mean_sums_in_f32_as_pallas(rng):
    b, n, c, s = 2, 128, 16, 64
    feat = torch.from_numpy(rng.randn(b, n, c).astype(np.float32)).to(torch.bfloat16)
    inds = rng.randint(-1, s, (b, n)).astype(np.int32)
    inds[:, :10] = 5  # a crowded voxel
    want, want_cnt = scatter_mean_pallas(jnp.asarray(feat.float().numpy(), jnp.bfloat16),
                                         jnp.asarray(inds), s, tile=32)
    out, cnt = scatter_mean(feat, torch.from_numpy(inds), s)
    assert out.dtype == cnt.dtype == torch.float32 and np.asarray(want).dtype == np.float32
    # Both sum the exact bf16 values in f32, in another order, then scale.
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))


def test_bf16_corner_gather_sums_in_f32_as_pallas(rng):
    b, n, c, s = 2, 64, 8, 128
    grid = torch.from_numpy(rng.randn(b, s, c).astype(np.float32)).to(torch.bfloat16)
    idx, w = _corners(rng, b, n, s)
    want = np.asarray(corner_gather_pallas(jnp.asarray(grid.float().numpy(), jnp.bfloat16),
                                           jnp.asarray(idx), jnp.asarray(w), tile=32))
    got = corner_gather(grid, torch.from_numpy(idx), torch.from_numpy(w))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    # f32 products of the exact bf16 grid values, summed in another order.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cin,cout", [(71, 64), (71, 128), (64, 64), (64, 128)])
def test_conv3d_plain_matches_pallas(rng, cin, cout):
    """K5's plain version against `conv3d_same_pallas` in interpret mode at
    r = 8 (one chunk of r³ rows), bf16 inputs."""
    b, r = 2, 8
    x = rng.randn(b, r, r, r, cin).astype(np.float32)
    x[:, :, :2] = 0.0  # empty voxels, as a sparse grid has
    kernel = (rng.randn(3, 3, 3, cin, cout) / np.sqrt(27 * cin)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    kb = jnp.asarray(kernel, jnp.bfloat16)
    want = np.asarray(_conv3d_experiment().conv3d_same_pallas(
        xb, kb, r, chunk=r ** 3, interpret=True).astype(jnp.float32))
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    wt = torch.from_numpy(np.array(kb.astype(jnp.float32))).permute(4, 3, 0, 1, 2)
    # A cin that is no multiple of 8 goes in as the model gives it to K5:
    # bf16 with a voxel stride padded to 8 channels.
    got = conv3d_same(padded_bf16(xt) if cin % 8 else xt, wt.to(torch.bfloat16).contiguous())
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, r, r, r, cout)
    got = got.float().numpy()
    # Both round an f32 sum of the same exact products once to bf16; the
    # sums differ in order, by f32 rounding, so the outputs are equal or one
    # bf16 step apart. Near 0 that step is the one at 2^-8 of the largest
    # output, where f32 cancellation is far below it.
    tol = bf16_ulp(np.maximum(np.abs(want), 2.0 ** -8 * np.abs(want).max()))
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()
    assert (got == want).mean() > 0.9
    # SAME zero padding on every axis: no wrap of α (axis 2) as the
    # devoxelization has.
    x_alpha = np.zeros_like(x)
    x_alpha[:, :, r - 1] = x[:, :, r - 1]
    y = conv3d_same_plain(torch.from_numpy(x_alpha).to(torch.bfloat16),
                          wt.to(torch.bfloat16).contiguous()).float().numpy()
    assert np.all(y[:, :, 0] == 0) and np.abs(y[:, :, r - 2]).max() > 0


def test_conv3d_wrapper_takes_plain_version_on_cpu_and_checks_inputs(rng):
    x = torch.randn(1, 4, 4, 4, 8).to(torch.bfloat16)
    w = torch.randn(16, 8, 3, 3, 3).to(torch.bfloat16)
    before = conv3d_same.launches
    assert torch.equal(conv3d_same(x, w), conv3d_same_plain(x, w))
    assert conv3d_same.launches == before
    with pytest.raises(ValueError, match="bf16"):
        conv3d_same(x.float(), w)
    with pytest.raises(ValueError, match="bf16"):
        conv3d_same(x, w.float())
    with pytest.raises(ValueError, match="contiguous"):
        conv3d_same(x.permute(0, 3, 2, 1, 4), w)
    with pytest.raises(ValueError, match="contiguous"):
        conv3d_same(x, w.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="w must be"):
        conv3d_same(x, w[:, :4].contiguous())


@pytest.mark.parametrize("kernel", ["normals_moments", "scatter_mean", "corner_scatter"])
def test_plain_matches_pallas_past_the_old_card_limit(rng, kernel):
    """K1, K2 and K4 at n = 2048 (ShapeNet's size, which the card refused
    before the kernels took any n) against the Pallas kernels."""
    b, n = 2, 2048
    if kernel == "normals_moments":
        pts = _cloud(rng, b, n, True)
        r2 = 0.002
        s1_j, s2_j, cnt_j = (np.asarray(a) for a in neighborhood_moments_pallas(
            jnp.asarray(pts), 16, r2, tile=128, interpret=True))
        s1, s2, cnt = (a.numpy() for a in neighborhood_moments(torch.from_numpy(pts), 16, r2))
        # As at n = 256: d² may differ by an ulp between the matmul and the
        # unfused sums, which can move a point across the radius.
        same = cnt == cnt_j
        assert same.mean() >= 0.99, same.mean()
        np.testing.assert_allclose(s1[same], s1_j[same], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(s2[same], s2_j[same], rtol=1e-5, atol=1e-5)
        return
    s, c = 4096, 8
    if kernel == "scatter_mean":
        feat = rng.randn(b, n, c).astype(np.float32)
        inds = rng.randint(-1, s, (b, n)).astype(np.int32)
        inds[:, :50] = 7  # a crowded voxel
        out_j, cnt_j = scatter_mean_pallas(jnp.asarray(feat), jnp.asarray(inds), s, tile=512)
        out, cnt = scatter_mean(torch.from_numpy(feat), torch.from_numpy(inds), s)
        np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))
        return
    idx, w = _corners(rng, b, n, s)
    dout = rng.randn(b, n, c).astype(np.float32)
    want = np.asarray(corner_scatter_pallas(jnp.asarray(dout), jnp.asarray(idx),
                                            jnp.asarray(w), s, tile=512))
    got = corner_scatter(torch.from_numpy(dout), torch.from_numpy(idx), torch.from_numpy(w), s)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [2048, 5000])
def test_wrappers_hold_no_size_limit(rng, n):
    """The wrappers take any cloud size: on the CPU they return the plain
    results at n = 2048 and 5000, and no module keeps a size constant."""
    for module in (normals_module, onehot_module, conv3d_module):
        assert not [name for name in vars(module) if name.startswith("MAX_")]
    pts = torch.from_numpy(_cloud(rng, 1, n, False))
    for a, b in zip(neighborhood_moments(pts, 8, 0.001), neighborhood_moments_plain(pts, 8, 0.001)):
        assert torch.equal(a, b)
    s = 512
    feat = torch.randn(1, n, 4)
    inds = torch.randint(-1, s, (1, n))
    assert all(torch.equal(a, b) for a, b in
               zip(scatter_mean(feat, inds, s), scatter_mean_plain(feat, inds, s)))
    idx = torch.randint(-1, s, (1, n, 8))
    w = torch.rand(1, n, 8)
    assert torch.equal(corner_scatter(feat, idx, w, s), corner_scatter_plain(feat, idx, w, s))


def test_moments_plain_by_query_chunks_is_the_whole(rng):
    """The plain K1 over query chunks (how the card check holds a cloud too
    large for one [n, n] d²) gives the unchunked result."""
    pts = torch.from_numpy(_cloud(rng, 2, 300, True))
    whole = neighborhood_moments_plain(pts, 16, 0.01)
    for a, b in zip(whole, neighborhood_moments_plain(pts, 16, 0.01, query_chunk=64)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cin,cout", [(71, 64), (64, 128), (24, 40), (128, 200)])
def test_conv3d_weight_taps_unpack_to_the_weight(rng, cin, cout):
    """K5's packed weights [27, cout_p, cin_p] (K-major taps, zero pad)
    give back the Conv3d weight [cout, cin, 3, 3, 3]."""
    w = torch.from_numpy(rng.randn(cout, cin, 3, 3, 3).astype(np.float32)).to(torch.bfloat16)
    taps = conv3d_module._weight_taps(w)
    n = conv3d_module.tile_width(cout)
    assert n == (64 if cout <= 64 else 128)
    cin_p = -(-cin // conv3d_module.CIN_STEP) * conv3d_module.CIN_STEP
    assert tuple(taps.shape) == (27, -(-cout // n) * n, cin_p) and taps.is_contiguous()
    back = taps[:, :cout, :cin].reshape(3, 3, 3, cout, cin).permute(3, 4, 0, 1, 2)
    assert torch.equal(back, w)
    assert not taps[:, cout:].any() and not taps[:, :, cin:].any()
    for i, j, k in ((0, 0, 0), (1, 2, 0), (2, 1, 2)):
        assert torch.equal(taps[(i * 3 + j) * 3 + k, :cout, :cin], w[:, :, i, j, k])


@pytest.mark.parametrize("cin", [71, 64])
def test_conv3d_padded_input_unpacks_to_x(rng, cin):
    """`padded_bf16` writes x in bf16 with a voxel stride of cin rounded up
    to 8 (the layout K5 reads by TMA); its view is the unpadded bf16 x, and
    the wrapper takes it as it takes a contiguous x."""
    x = torch.from_numpy(rng.randn(2, 4, 4, 4, cin).astype(np.float32))
    xp = padded_bf16(x)
    cs = -(-cin // 8) * 8
    assert xp.dtype == torch.bfloat16 and tuple(xp.shape) == tuple(x.shape)
    assert xp.stride() == (64 * cs, 16 * cs, 4 * cs, cs, 1)
    assert conv3d_module._voxel_stride(xp) == cs
    assert torch.equal(xp.contiguous(), x.to(torch.bfloat16))
    w = torch.from_numpy(rng.randn(16, cin, 3, 3, 3).astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(conv3d_same(xp, w), conv3d_same_plain(x.to(torch.bfloat16), w))


@pytest.mark.parametrize("kernel", ["scatter_mean", "corner_scatter"])
@pytest.mark.parametrize("case", ["one_voxel", "all_dropped", "empty_cloud"])
def test_plain_matches_pallas_on_degenerate_clouds(rng, kernel, case):
    """K2's and K4's plain versions against the Pallas kernels (interpret
    mode) on the inputs that take the card's kernels down their rarest
    paths: every point of a cloud in one voxel, every index -1, and one
    cloud of the batch with no entry at all."""
    b, n, c, s = 2, 512, 8, 64
    entries = (b, n) if kernel == "scatter_mean" else (b, n, 8)
    ind = rng.randint(-1, s, entries).astype(np.int32)
    if case == "one_voxel":
        ind[:] = 5
        ind[1] = 37
    elif case == "all_dropped":
        ind[:] = -1
    else:
        ind[1] = -1
    feat = rng.randn(b, n, c).astype(np.float32)
    if kernel == "scatter_mean":
        want, want_cnt = (np.asarray(a) for a in scatter_mean_pallas(
            jnp.asarray(feat), jnp.asarray(ind), s, tile=32))
        got, cnt = (a.numpy() for a in scatter_mean(torch.from_numpy(feat),
                                                    torch.from_numpy(ind), s))
        np.testing.assert_array_equal(cnt, want_cnt)
        assert cnt.sum() == (ind >= 0).sum()
        # Sums of the same points in another order.
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        w = rng.rand(b, n, 8).astype(np.float32)
        want = np.asarray(corner_scatter_pallas(jnp.asarray(feat), jnp.asarray(ind),
                                                jnp.asarray(w), s, tile=32))
        got = corner_scatter(*map(torch.from_numpy, (feat, ind, w)), s).numpy()
        # Weighted rows summed in another order: one voxel adds 4096 of
        # them, whose sum may cancel, so the rounding is bounded by the sum
        # of their magnitudes (1e-6 of it: about 17 times f32's unit roundoff).
        mass = corner_scatter(*map(torch.from_numpy, (np.abs(feat), ind, w)), s).numpy()
        assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-6 * mass + 1e-7)
    if case != "one_voxel":
        assert not got[1].any()  # an empty cloud writes zeros only
    else:
        assert not np.delete(got[0], 5, axis=0).any() and got[0, 5].any()


def _c_entry_points():
    """{name: [kind of each parameter: "pointer", "int" or "float"]} of every
    `extern "C"` function in csrc/*.cu."""
    import re

    found = {}
    for path in sorted(glob.glob(os.path.join(ROOT, "rift_tpu_torch", "csrc", "*.cu"))):
        with open(path) as f:
            text = f.read()
        for name, params in re.findall(r'extern "C"\s+int\s+(\w+)\s*\(([^)]*)\)', text):
            found[name] = ["pointer" if "*" in p else p.split()[0] for p in params.split(",")]
    return found


def test_c_entry_points_match_the_ctypes_signatures():
    """Each `extern "C"` entry point of csrc/*.cu takes the arguments that
    build._SIGNATURES gives ctypes, in number and kind: a pointer (or the
    stream, void*) as c_void_p, an int as c_int, a float as c_float. No
    compiler runs on the CPU to catch a mismatch."""
    import ctypes

    from rift_tpu_torch.ops.cuda import build

    kinds = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_float: "float"}
    entries = _c_entry_points()
    assert sorted(entries) == sorted(build._SIGNATURES)
    for name, params in entries.items():
        assert params == [kinds[t] for t in build._SIGNATURES[name]], (name, params)


@pytest.mark.parametrize("b,s,entries,c,tile", [
    (32, 32768, 1024, 67, 256),     # K2 at the registration shape
    (32, 32768, 1024, 64, 256),
    (16, 32768, 8192, 64, 256),     # K4 at the training shape
    (16, 32768, 8192, 128, 128),
    (16, 32768, 1024, 512, 32),     # wide rows: the smallest
    (512, 32768, 131072, 64, 1024),  # more entries than any span: the largest
    (2, 32768, 5000, 64, 64),       # few clouds: halved to 1024 blocks
    (1, 32768, 131072, 64, 32),     # one cloud: the smallest tile
    (2, 27, 100, 3, 27),            # fewer voxels than a tile: one tile of s
])
def test_voxel_tile_spans_64_kb_and_twice_the_index_list(b, s, entries, c, tile):
    """K2's and K4's voxels per block: the smallest tile whose output span
    is at least 64 KB and twice the cloud's index list (the largest where
    none is), halved while the launch has fewer than 1024 blocks, never
    more than s."""
    got = onehot_module.voxel_tile(b, s, entries, c)
    assert got == tile
    assert got in onehot_module.VOXEL_TILES or got == s
    if got > onehot_module.VOXEL_TILES[0] and got < s:
        assert b * -(-s // got) >= onehot_module.TILE_MIN_BLOCKS


def test_scatter_wrappers_reject_batches_past_32_bit_indices():
    """K2 and K4 index the batch's grid and entries with 32-bit ints: the
    size check raises at 2^31, not below."""
    onehot_module._check_sizes(2 ** 15, 2 ** 16 - 1, 1024)
    with pytest.raises(ValueError, match="below 2"):
        onehot_module._check_sizes(2 ** 15, 2 ** 16, 1024)
    with pytest.raises(ValueError, match="below 2"):
        onehot_module._check_sizes(2 ** 12, 8, 2 ** 19)


def _built_d2(case, rng):
    """(d² [m, n] f32 >= 0, k) built so the k-th smallest sits where the
    bisection is hard: "ulps" — a run of 12 values each 1-3 ulps above the
    last at 1e-3 (below it 5 small values, above it values up to 4), k
    inside the run; "ties" — 9 copies of one value covering rank k; "zeros"
    — every d² 0 (the empty-bracket rule); "k1" — random, k = 1; "k_eq_n"
    and "k_gt_n" — random, k = n and k = n + 5."""
    m, n = 24, 64
    d2 = rng.uniform(0.0, 4.0, (m, n)).astype(np.float32)
    if case == "ulps":
        for i in range(m):
            run = [np.float32(1e-3)]
            for _ in range(11):
                v = run[-1]
                for _ in range(rng.randint(1, 4)):
                    v = np.nextafter(v, np.float32(np.inf), dtype=np.float32)
                run.append(v)
            d2[i, :5] = rng.uniform(0.0, 1e-4, 5).astype(np.float32)
            d2[i, 5:17] = run
            d2[i] = d2[i, rng.permutation(n)]
        return d2, 5 + 1 + 6
    if case == "ties":
        d2[:, :4] = rng.uniform(0.0, 1e-4, (m, 4)).astype(np.float32)
        d2[:, 4:13] = np.float32(2e-3)
        return d2, 8
    if case == "zeros":
        return np.zeros((m, n), np.float32), 16
    return d2, {"k1": 1, "k_eq_n": n, "k_gt_n": n + 5}[case]


@pytest.mark.parametrize("k", [1, 7, 16, 32, 33, 256])
def test_select_and_replay_is_the_bisection_on_random_d2(rng, k):
    """K1's algorithm (exact k-th smallest, the 32 steps replayed on it, the
    bracket min) gives `_hybrid_radius_sq`'s bits on d² of random clouds."""
    pts = torch.from_numpy(rng.uniform(-1.0, 1.0, (2, 256, 3)).astype(np.float32))
    d2 = point_sqdist(pts, pts)
    for r2 in (0.0, 0.01):
        want = normals_module._hybrid_radius_sq(d2, k, r2)
        got = normals_module.hybrid_radius_sq_by_select(d2, k, r2)
        assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["ulps", "ties", "zeros", "k1", "k_eq_n", "k_gt_n"])
def test_select_and_replay_is_the_bisection_on_built_d2(rng, case):
    """The same bits on d² built to be hard: runs of values a few ulps
    apart and ties at the k-th, all zeros, k = 1 and k >= n."""
    d2, k = _built_d2(case, rng)
    d2 = torch.from_numpy(d2)
    for r2 in (0.0, 1e-6):
        want = normals_module._hybrid_radius_sq(d2, k, r2)
        got = normals_module.hybrid_radius_sq_by_select(d2, k, r2)
        assert torch.equal(got, want), (case, r2)


def test_exact_kth_is_not_the_bisection_answer_on_built_d2(rng):
    """The replay is needed: on the built d² the radius from the exact k-th
    smallest (times 1 + 1e-6) differs from the bisection's at some queries,
    which the select-and-replay algorithm still matches."""
    differ = 0
    for case in ("ulps", "ties", "zeros", "k1"):
        d2, k = _built_d2(case, rng)
        d2 = torch.from_numpy(d2)
        kth = torch.kthvalue(d2, k, dim=-1).values
        exact = kth * torch.tensor(1.0 + 1e-6, dtype=torch.float32)
        differ += int((exact != normals_module._hybrid_radius_sq(d2, k, 0.0)).sum())
    assert differ > 0


def test_point_sqdist_sorts_as_its_uint32_bits(rng):
    """Non-negative f32 d² from point_sqdist (coincident points included)
    sort the same as their bits as uint32 with the sign masked: K1's radix
    select orders the keys so."""
    pts = rng.uniform(-1.0, 1.0, (2, 300, 3)).astype(np.float32)
    pts[:, 1:6] = pts[:, :1]
    d2 = point_sqdist(torch.from_numpy(pts), torch.from_numpy(pts)).reshape(-1)
    assert bool((d2 >= 0).all())
    keys = d2.view(torch.int32) & 0x7FFFFFFF  # non-negative, so int64 order is uint32 order
    by_bits = d2[torch.argsort(keys.long(), stable=True)]
    assert torch.equal(by_bits, torch.sort(d2, stable=True).values)


@pytest.mark.parametrize("index_type", [np.int64, np.int32])
def test_corner_gather_plain_on_int64_and_int32_matches_pallas_at_c67(rng, index_type):
    """K3's plain version takes int64 (the path's) and int32 indices alike:
    the same bits, and within the one-hot kernel's summation order of
    corner_gather_pallas at c = 67 (no whole 16-byte vectors on the card),
    with -1, s and s + 1 dropped."""
    b, n, c, s = 2, 64, 67, 128
    grid = rng.randn(b, s, c).astype(np.float32)
    idx = rng.randint(0, s, (b, n, 8)).astype(np.int64)
    idx[0, 3] = -1
    idx[1, 5, :2] = [s, s + 1]
    w = rng.rand(b, n, 8).astype(np.float32)
    want = np.asarray(corner_gather_pallas(jnp.asarray(grid), jnp.asarray(idx.astype(np.int32)),
                                           jnp.asarray(w), tile=32))
    got = corner_gather(torch.from_numpy(grid), torch.from_numpy(idx.astype(index_type)),
                        torch.from_numpy(w))
    other = corner_gather_plain(torch.from_numpy(grid), torch.from_numpy(idx), torch.from_numpy(w))
    assert torch.equal(got, other)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert np.all(got.numpy()[0, 3] == 0)
