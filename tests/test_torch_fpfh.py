"""rift_tpu_torch's FPFH (`ops/fpfh.py`) against rift_tpu's on the CPU:
random clouds, points with no neighbour in the radius, angles on the bin
edges and at ±1 and ±π, clouds of fewer points than k; `fpfh_from_knn` on
one neighbour list (self-counting entries included) against the
reference's `fpfh` fed that list; rotation invariance on a fixed
neighbour list; and the two packages' `knn` making the same self
decisions on the same cloud.

Every descriptor carries a mass of 100 per sub-histogram; both are held
within FPFH_TOL of that scale."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rift_tpu.ops.fpfh as j_fpfh
from rift_tpu.ops.neighbors import knn as j_knn
from rift_tpu_torch.ops.fpfh import _histogram, fpfh, fpfh_from_knn
from rift_tpu_torch.ops.neighbors import knn

# The same function on the same neighbour list in another summation order.
FPFH_TOL = 1e-4 * 100.0


def _cloud(rng, b, n, scale=0.2):
    pts = (rng.randn(b, n, 3) * scale).astype(np.float32)
    nrm = rng.randn(b, n, 3).astype(np.float32)
    return pts, (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)


def _both(pts, nrm, **kw):
    got = fpfh(torch.from_numpy(pts), torch.from_numpy(nrm), **kw).numpy()
    want = np.asarray(j_fpfh.fpfh(jnp.asarray(pts), jnp.asarray(nrm), **kw))
    return got, want


@pytest.mark.parametrize("case", ["random", "isolated", "fewer_than_k"])
def test_fpfh_matches_reference(rng, case):
    """Random clouds (b = 2, n = 256); a cloud with points far from every
    other (no neighbour in the radius: the descriptor is 0); n = 40 < k =
    64 (knn repeats the farthest neighbour). A point far from the origin
    whose d² to itself rounds above 1e-12 counts itself, in both packages:
    the isolated points sit where that d² is exact."""
    n = 40 if case == "fewer_than_k" else 256
    pts, nrm = _cloud(rng, 2, n)
    if case == "isolated":
        # At (2, 0, 0), (4, 0, 0), ...: whole numbers, so every d² to them,
        # self included, is exact and none counts itself.
        pts[:, :8] = 0.0
        pts[:, :8, 0] = 2.0 * np.arange(1, 9)
    got, want = _both(pts, nrm)
    assert got.shape == want.shape == (2, n, 33)
    np.testing.assert_allclose(got, want, rtol=0, atol=FPFH_TOL)
    # Each sub-histogram sums to 100, or to 0 at a point with no
    # neighbour in the radius.
    sums = want.reshape(2, n, 3, 11).sum(-1)
    lonely = (sums == 0).all(-1)
    np.testing.assert_allclose(sums[~lonely], 100.0, rtol=1e-5)
    assert lonely.mean() < 0.1
    if case == "isolated":
        assert lonely[:, :8].all() and np.all(got[:, :8] == 0)


def test_histogram_on_bin_edges_and_range_ends():
    """The soft histogram of α, φ (on [-1, 1]) and θ (on [-π, π]) at every
    bin edge and centre, at ±1 and ±π, and past the range (clamped), with
    a mask: the reference's values."""
    for lo, hi in ((-1.0, 1.0), (-np.pi, np.pi)):
        span = hi - lo
        edges = lo + span * np.arange(12) / 11
        centres = lo + span * (np.arange(11) + 0.5) / 11
        vals = np.concatenate([edges, centres, [lo, hi, lo - 0.1, hi + 0.1,
                                                np.nextafter(np.float32(hi), 0)]])
        vals = np.tile(vals.astype(np.float32), (3, 1))
        mask = np.ones(vals.shape, bool)
        mask[1, ::2] = False
        mask[2] = False
        got = _histogram(torch.from_numpy(vals), lo, hi, torch.from_numpy(mask)).numpy()
        want = np.asarray(j_fpfh._histogram(jnp.asarray(vals), lo, hi, jnp.asarray(mask)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.sum(-1), mask.sum(-1), rtol=1e-6)


def test_fpfh_angles_at_the_range_ends_match_reference():
    """Neighbours placed so that α and φ reach ±1 (a neighbour along the
    normal, and against it) and θ reaches ±π (a neighbour's normal
    opposite the point's)."""
    pts = np.array([[[0, 0, 0], [0, 0, 0.1], [0, 0, -0.1], [0.1, 0, 0], [0, 0.1, 0],
                     [-0.1, 0, 0]]], np.float32)
    nrm = np.array([[[0, 0, 1], [0, 0, 1], [0, 0, -1], [0, 0, -1], [1, 0, 0],
                     [0, -1, 0]]], np.float32)
    got, want = _both(pts, nrm)
    np.testing.assert_allclose(got, want, rtol=0, atol=FPFH_TOL)


def _reference_on_list(monkeypatch, pts, nrm, d2, idx, radius=0.3):
    """The reference's `fpfh` with its `knn` replaced by the given list."""
    monkeypatch.setattr(j_fpfh, "knn", lambda q, p, k: (jnp.asarray(d2), jnp.asarray(idx)))
    return np.asarray(j_fpfh.fpfh(jnp.asarray(pts), jnp.asarray(nrm), radius=radius))


def test_fpfh_from_knn_on_one_neighbour_list_equals_reference(rng, monkeypatch):
    """Both packages on the reference's neighbour list, with the d² of a
    third of the points to themselves set to 1.19e-7 (the largest self d²
    an f32 ‖a‖² + ‖b‖² − 2a·b gives on the unit ball): those points count
    themselves, at a weight of ~2900, in both."""
    pts, nrm = _cloud(rng, 2, 256)
    d2, idx = (np.array(a) for a in j_knn(jnp.asarray(pts), jnp.asarray(pts), 64))
    self_slot = idx == np.arange(256)[None, :, None]
    assert self_slot.any(-1).all()
    counted = self_slot & (np.arange(256)[None, :, None] % 3 == 0)
    d2[counted] = np.float32(1.19e-7)
    d2[self_slot & ~counted] = 0.0
    want = _reference_on_list(monkeypatch, pts, nrm, d2, idx)
    got = fpfh_from_knn(torch.from_numpy(pts), torch.from_numpy(nrm), torch.from_numpy(d2),
                        torch.from_numpy(idx).long(), 0.3).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FPFH_TOL)
    # Counting self moves the descriptor: the decision is part of the function.
    d2[counted] = 0.0
    off = fpfh_from_knn(torch.from_numpy(pts), torch.from_numpy(nrm), torch.from_numpy(d2),
                        torch.from_numpy(idx).long(), 0.3).numpy()
    assert np.abs(off - got)[:, ::3].max() > 1.0


def test_fpfh_is_rotation_invariant_on_a_fixed_neighbour_list(rng):
    """As tests/test_misc_modules.py:66 holds the reference, but with the
    neighbour list held fixed, so no radius test flips: the rotated cloud's
    descriptor is the cloud's to rounding in the angles."""
    pts, nrm = _cloud(rng, 1, 256)
    q, _ = np.linalg.qr(rng.randn(3, 3))
    rot = (q * np.sign(np.linalg.det(q))).astype(np.float32)
    d2, idx = knn(torch.from_numpy(pts), torch.from_numpy(pts), 64)
    f1 = fpfh_from_knn(torch.from_numpy(pts), torch.from_numpy(nrm), d2, idx, 0.3).numpy()
    f2 = fpfh_from_knn(torch.from_numpy(pts @ rot.T), torch.from_numpy(nrm @ rot.T), d2, idx,
                       0.3).numpy()
    np.testing.assert_allclose(f1, f2, rtol=0, atol=1e-2)


def test_knn_self_decisions_match_reference_on_the_cpu(rng):
    """Which points count themselves (d² to self > 1e-12 after rounding)
    is decided by how each package rounds a·a: on the CPU the port's `knn`
    gives the reference's lists bit for bit, so the same points count
    themselves (some do: the decision is not vacuous)."""
    pts = rng.randn(4, 1024, 3).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True) / rng.uniform(0, 1, (4, 1024, 1))
    pts = pts.astype(np.float32)
    d2, idx = knn(torch.from_numpy(pts), torch.from_numpy(pts), 64)
    jd2, jidx = j_knn(jnp.asarray(pts), jnp.asarray(pts), 64)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(jd2))
    self_d2 = np.where(idx.numpy() == np.arange(1024)[None, :, None], d2.numpy(), 0.0).max(-1)
    assert 0.0 < (self_d2 > 1e-12).mean() < 0.5
