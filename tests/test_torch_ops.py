"""rift_tpu_torch's geometry ops against their rift_tpu twins on the same
numpy inputs (JAX on the CPU, f32 on both sides)."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.ops import eig3 as j_eig3
from rift_tpu.ops import lrf as j_lrf
from rift_tpu.ops import neighbors as j_nb
from rift_tpu.ops import normals as j_normals
from rift_tpu.ops import se3 as j_se3
from rift_tpu.ops import spherical as j_sph
from rift_tpu_torch.ops import eig3, lrf, neighbors, normals, ppf, se3, spherical

j_ppf = importlib.import_module("rift_tpu.ops.ppf")  # the package re-exports a function `ppf`


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _sym(rng, m):
    a = rng.randn(m, 3, 3).astype(np.float32)
    a = a + np.swapaxes(a, -1, -2)
    a[0] = np.eye(3)          # repeated eigenvalue: the +z fallback
    a[1] = 0.0                # zero matrix
    a[2] = np.diag([1.0, 1.0, 2.0])
    return a.astype(np.float32)


def test_eig3_matches_reference(rng):
    a = _sym(rng, 64)
    # Rows 0 and 1 (identity, zero matrix): the reference's jnp.linalg.det
    # of the zero shifted matrix is NaN on the CPU, so its eigenvalues are
    # NaN there; the port's closed-form determinant is 0 and stays finite.
    # Compare the other rows, and check the port on those two directly.
    ok = slice(2, None)
    # Same closed form; arccos/cos and the determinant round differently by
    # an ulp or two, amplified where eigenvalues cluster.
    for got, want in zip(eig3.eigvals_sym3(_t(a)), j_eig3.eigvals_sym3(jnp.asarray(a))):
        np.testing.assert_allclose(got.numpy()[ok], np.asarray(want)[ok], rtol=1e-4, atol=1e-4)
    vals, vecs = eig3.eigh_sym3(_t(a))
    wvals, wvecs = j_eig3.eigh_sym3(jnp.asarray(a))
    np.testing.assert_allclose(vals.numpy()[ok], np.asarray(wvals)[ok], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(vecs.numpy()[ok], np.asarray(wvecs)[ok], atol=2e-3)
    np.testing.assert_allclose(vals.numpy()[:2], [[1, 1, 1], [0, 0, 0]], atol=1e-6)
    assert np.isfinite(vecs.numpy()).all()
    v = eig3.smallest_eigenvector_sym3(_t(a)).numpy()
    want_v = np.asarray(j_eig3.smallest_eigenvector_sym3(jnp.asarray(a)))
    np.testing.assert_allclose(v[ok], want_v[ok], atol=2e-3)
    comps = [a[:, 0, 0], a[:, 0, 1], a[:, 0, 2], a[:, 1, 1], a[:, 1, 2], a[:, 2, 2]]
    got = eig3.smallest_eigenvector_sym3_components(*map(_t, comps))
    want = j_eig3.smallest_eigenvector_sym3_components(*map(jnp.asarray, comps))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-3)
    assert np.allclose(v[:2], [0, 0, 1])  # degenerate -> +z, as the components form


def _cloud(rng, b=2, n=256):
    pts = rng.randn(b, n, 3).astype(np.float32) * np.array([1.0, 0.6, 0.3], np.float32)
    return pts - pts.mean(1, keepdims=True)


@pytest.mark.parametrize("kind", ["pca", "reference"])
def test_lrf_and_change_coords_match_reference(rng, kind):
    pts = _cloud(rng)
    basis = lrf.lrf_basis(_t(pts), kind)
    want = j_lrf.lrf_basis(jnp.asarray(pts), kind)
    # A well-conditioned cloud: the frames agree to f32 rounding.
    np.testing.assert_allclose(basis.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(lrf.change_coords(_t(pts), basis).numpy(),
                               np.asarray(j_lrf.change_coords(jnp.asarray(pts), want)),
                               atol=1e-4)


def test_ppf_and_local_ppf_match_reference(rng):
    c = rng.randn(2, 32, 3).astype(np.float32)
    ctr = rng.randn(2, 32, 3).astype(np.float32)
    n1 = rng.randn(2, 32, 3).astype(np.float32)
    n2 = rng.randn(2, 32, 3).astype(np.float32)
    n1[0, :4] = 0.0  # undefined normals -> zero feature
    got = ppf.ppf(_t(c), _t(ctr), _t(n1), _t(n2)).numpy()
    want = np.asarray(j_ppf.ppf(*map(jnp.asarray, (c, ctr, n1, n2))))
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.all(got[0, :4] == 0)
    nbr = rng.randn(2, 16, 8, 3).astype(np.float32)
    nbr_n = rng.randn(2, 16, 8, 3).astype(np.float32)
    nbr_n /= np.linalg.norm(nbr_n, axis=-1, keepdims=True)
    cc = rng.randn(2, 16, 3).astype(np.float32)
    cn = rng.randn(2, 16, 3).astype(np.float32)
    cn /= np.linalg.norm(cn, axis=-1, keepdims=True)
    nbr[0, 0, 0] = cc[0, 0]  # zero offset: d̂ = 0
    got = ppf.local_ppf(*map(_t, (nbr, nbr_n, cc, cn))).numpy()
    want = np.asarray(j_ppf.local_ppf(*map(jnp.asarray, (nbr, nbr_n, cc, cn))))
    # arccos near ±1 turns an ulp into ~3e-4 rad.
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_global_ppf_matches_reference(rng):
    c = (rng.randn(2, 200, 3) * [1.0, 0.6, 0.3]).astype(np.float32)
    n = rng.randn(2, 200, 3).astype(np.float32) * 3.0  # not unit: normalized first
    n[0, :3] = 0.0  # zero normals: undefined, a zero feature
    got = ppf.global_ppf(_t(c), _t(n)).numpy()
    want = np.asarray(j_ppf.global_ppf(jnp.asarray(c), jnp.asarray(n)))
    assert got.shape == (2, 200, 4)
    # The same closed form; the centroid and mean normal are sums of 200
    # terms in another order, and arccos near ±1 turns an ulp into ~3e-4 rad.
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_allclose(got[..., 3], want[..., 3], rtol=1e-5, atol=1e-6)
    assert np.all(got[0, :3] == 0)


def _ball_cloud(rng):
    pts = rng.uniform(-1, 1, (2, 128, 3)).astype(np.float32)
    pts[:, 0] = 10.0  # isolated: nearest-point fallback, which is the
    pts[:, 1] = 10.3  # point itself (d² = 0 is excluded only from the ball)
    return pts


@pytest.mark.parametrize("u", [8, 200])  # 200 > n: empty padding slots
def test_ball_query_matches_reference(rng, u):
    pts = _ball_cloud(rng)
    r = 0.4
    got = neighbors.ball_query(_t(pts), _t(pts), r, u).numpy()
    want = np.asarray(j_nb.ball_query(jnp.asarray(pts), jnp.asarray(pts), r, u))
    # d² via two different f32 matmuls: a point on the radius may flip.
    rows_same = np.all(got == want, axis=-1)
    assert rows_same.mean() >= 0.99, rows_same.mean()
    assert np.all(got[:, 0] == 0) and np.all(got[:, 1] == 1)


@pytest.mark.parametrize("u", [8, 200])
def test_ball_query_group_matches_reference(rng, u):
    pts = _ball_cloud(rng)
    feats = rng.randn(2, 128, 5).astype(np.float32)
    r = 0.4
    got, ok = neighbors.ball_query_group(_t(pts), _t(pts), _t(feats), r, u)
    want, want_ok = j_nb.ball_query_group(jnp.asarray(pts), jnp.asarray(pts),
                                          jnp.asarray(feats), r, u)
    rows_same = np.all(ok.numpy() == np.asarray(want_ok), axis=-1) & np.all(
        np.isclose(got.numpy(), np.asarray(want), atol=1e-6), axis=(-2, -1))
    assert rows_same.mean() >= 0.99, rows_same.mean()
    assert ok.numpy()[:, 0].sum(-1).tolist() == [1, 1]  # fallback: slot 0 only
    np.testing.assert_array_equal(got.numpy()[:, 0, 0], feats[:, 0])
    # Masked max, the consumer's reduction, equals ball_query + grouping.
    idx = neighbors.ball_query(_t(pts), _t(pts), r, u)
    full = neighbors.grouping(_t(feats), idx).amax(-2)
    masked = got.masked_fill(~ok[..., None], float("-inf")).amax(-2)
    assert torch.equal(full, masked)


def test_mutual_nearest_neighbors_matches_reference(rng):
    f1 = rng.randn(2, 96, 16).astype(np.float32)
    f2 = np.concatenate([f1[:, ::-1][:, :60], rng.randn(2, 40, 16).astype(np.float32)], 1)
    f2[:, 60] = f2[:, 0]  # a duplicate: ties go to the first index
    _, i2, m = neighbors.mutual_nearest_neighbors(_t(f1), _t(f2))
    for b in range(2):
        _, wi2, wm = j_nb.mutual_nearest_neighbors(jnp.asarray(f1[b]), jnp.asarray(f2[b]))
        np.testing.assert_array_equal(i2[b].numpy(), np.asarray(wi2))
        np.testing.assert_array_equal(m[b].numpy(), np.asarray(wm))
    assert m.float().mean() > 0.5


def test_spherical_indices_and_corner_weights_match_reference(rng):
    pts = rng.randn(2, 512, 3).astype(np.float32)
    pts[:, 5] = [0.0, 0.3, 0.1]   # x == 0
    pts[:, 6] = [0.0, 0.0, 0.2]   # x == y == 0
    r = 16
    norm = spherical.normalize_coords_sphere(_t(pts))
    j_norm = j_sph.normalize_coords_sphere(jnp.asarray(pts))
    np.testing.assert_allclose(norm.numpy(), np.asarray(j_norm), atol=1e-6)
    inds, defined = spherical.spherical_voxel_indices(norm, r)
    j_inds, _ = j_sph.spherical_voxel_indices(j_norm, r)
    # atan/acos differ by an ulp between libraries: a point on a bin
    # boundary may change bins.
    assert (inds.numpy() == np.asarray(j_inds)).mean() >= 0.99
    far = np.linalg.norm(pts - pts.mean(1, keepdims=True), axis=-1).argmax(-1)
    assert all(inds[b, far[b]] == -1 for b in range(2))  # γ = 1: undefined
    idx, w = spherical.spherical_corner_weights(norm, inds, r)
    j_idx, j_w = j_sph.spherical_corner_weights(j_norm, j_inds, r)
    same = np.all(idx.numpy() == np.asarray(j_idx), axis=-1)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(w.numpy()[same], np.asarray(j_w)[same], atol=1e-5)
    assert all(np.all(idx[b, far[b]].numpy() == -1) for b in range(2))
    np.testing.assert_allclose(w.sum(-1).numpy()[inds.numpy() >= 0], 1.0, atol=1e-5)


def test_voxelize_devoxelize_match_reference(rng):
    pts = rng.randn(2, 256, 3).astype(np.float32)
    feat = rng.randn(2, 256, 6).astype(np.float32)
    r = 8
    grid, inds, norm = spherical.spherical_avg_voxelize(_t(feat), _t(pts), r)
    j_grid, j_inds, j_norm = j_sph.spherical_avg_voxelize(
        jnp.asarray(feat), jnp.asarray(pts), r)
    if np.array_equal(inds.numpy(), np.asarray(j_inds)):
        np.testing.assert_allclose(grid.numpy(), np.asarray(j_grid), atol=1e-5)
    out = spherical.spherical_trilinear_devoxelize(grid, norm, inds, r)
    j_out = j_sph.spherical_trilinear_devoxelize(j_grid, j_norm, j_inds, r)
    pt_same = np.all(np.isclose(out.numpy(), np.asarray(j_out), atol=1e-4), axis=-1)
    assert pt_same.mean() >= 0.99
    assert np.all(out.numpy()[inds.numpy() < 0] == 0)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_estimate_normals_matches_reference(rng, impl):
    # A noisy ellipsoid shell: well-defined planes almost everywhere.
    u = rng.uniform(0, 2 * np.pi, (2, 256))
    v = rng.uniform(0, np.pi, (2, 256))
    pts = np.stack([np.sin(v) * np.cos(u), 0.7 * np.sin(v) * np.sin(u), 0.5 * np.cos(v)], -1)
    pts = (pts + 0.003 * rng.randn(*pts.shape)).astype(np.float32)
    got = normals.estimate_normals(_t(pts)).numpy()
    want = np.asarray(j_normals.estimate_normals(jnp.asarray(pts), impl=impl))
    # A one-ulp d² difference can move a neighbour across the radius and
    # tilt that point's normal: bound the share of points that differ.
    close = np.all(np.abs(got - want) < 1e-3, axis=-1)
    assert close.mean() >= 0.99, close.mean()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    assert np.all(np.sum(got * -pts, -1) >= -1e-6)  # oriented towards the origin


def _shell(rng):
    """A noisy ellipsoid shell [2, 256, 3]: well-defined planes almost
    everywhere."""
    u = rng.uniform(0, 2 * np.pi, (2, 256))
    v = rng.uniform(0, np.pi, (2, 256))
    pts = np.stack([np.sin(v) * np.cos(u), 0.7 * np.sin(v) * np.sin(u), 0.5 * np.cos(v)], -1)
    return (pts + 0.003 * rng.randn(*pts.shape)).astype(np.float32)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("camera", [(0.0, 0.1, 3.0), (2.0, 0.5, -1.0)])
def test_estimate_normals_with_a_camera_matches_reference(rng, impl, camera):
    """Each normal flipped so that n·(camera − p) >= 0, by
    test_estimate_normals_matches_reference's tolerance; `max_neighbors` is
    accepted and ignored, as in the reference."""
    pts = _shell(rng)
    cam = np.asarray(camera, np.float32)
    got = normals.estimate_normals(_t(pts), camera=_t(cam)).numpy()
    want = np.asarray(j_normals.estimate_normals(jnp.asarray(pts), camera=jnp.asarray(cam),
                                                 impl=impl))
    close = np.all(np.abs(got - want) < 1e-3, axis=-1)
    assert close.mean() >= 0.99, close.mean()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    assert np.all(np.sum(got * (cam - pts), -1) >= -1e-6)  # oriented towards the camera
    at_origin = normals.estimate_normals(_t(pts)).numpy()
    # Outside the convex shell the camera turns the normals facing it.
    assert np.any(np.sum(got * at_origin, -1) < 0)
    capped = normals.estimate_normals(_t(pts), max_neighbors=4, camera=_t(cam)).numpy()
    np.testing.assert_array_equal(capped, got)


def test_transform_points_without_translation_matches_reference(rng):
    pts = rng.randn(3, 50, 3).astype(np.float32)
    tr = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    for i in range(3):
        tr[i, :3, :3] = np.linalg.qr(rng.randn(3, 3))[0]
        tr[i, :3, 3] = rng.uniform(-1, 1, 3)
    for with_translate in (True, False):
        got = se3.transform_points(_t(tr), _t(pts), with_translate=with_translate).numpy()
        want = np.asarray(j_se3.transform_points(jnp.asarray(tr), jnp.asarray(pts),
                                                 with_translate=with_translate))
        np.testing.assert_allclose(got, want, atol=1e-6)
    rotated = se3.transform_points(_t(tr), _t(pts), with_translate=False)
    np.testing.assert_array_equal(rotated + _t(tr)[:, None, :3, 3], se3.transform_points(
        _t(tr), _t(pts)))
