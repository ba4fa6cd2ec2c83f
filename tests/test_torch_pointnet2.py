"""rift_tpu_torch's PointNet++ pieces against rift_tpu's on the CPU: `knn`
(ties, and fewer points than neighbours), `ball_group`,
`three_nn_interpolate`, the three PointNet++ modules and the PointNet
models, on the reference's weights carried across by `weights.from_flax`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rift_tpu.models.pointnet as j_pointnet
import rift_tpu_torch.models.pointnet as t_pointnet
from rift_tpu.models import PointNetClassifier as JaxPointNetClassifier
from rift_tpu.models.pointnet import PointNet as JaxPointNet
from rift_tpu.nn.pointnet2 import PointNetAModule as JaxA
from rift_tpu.nn.pointnet2 import PointNetFPModule as JaxFP
from rift_tpu.nn.pointnet2 import PointNetSAModule as JaxSA
from rift_tpu.ops import neighbors as jn
from rift_tpu.ops.lrf import pca_align as j_pca_align
from rift_tpu_torch.models import PointNet, PointNetClassifier
from rift_tpu_torch.nn import PointNetAModule, PointNetFPModule, PointNetSAModule
from rift_tpu_torch.ops import neighbors as tn
from rift_tpu_torch.ops.lrf import pca_align
from rift_tpu_torch.weights import from_flax

# The same f32 arithmetic as the reference on the same neighbours; the
# grouped MLPs add Dense/BatchNorm rounding in another summation order.
OPS_TOL = 1e-5
MODULE_RTOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _weights(jmodule, *args):
    v = jmodule.init(jax.random.PRNGKey(0), *map(_j, args), train=False)
    return jax.tree_util.tree_map(np.asarray, v)


def _port(module, v):
    module.load_state_dict(from_flax(v["params"], v["batch_stats"]))
    return module.eval()


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=MODULE_RTOL * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("m, k", [(50, 8), (5, 8), (3, 3)])
def test_knn_matches_reference(rng, m, k):
    """m >= k, and m < k (the farthest neighbour repeats in the last
    slots); indices equal, distances within OPS_TOL."""
    q = rng.randn(2, 20, 3).astype(np.float32)
    p = rng.randn(2, m, 3).astype(np.float32)
    d, idx = tn.knn(_t(q), _t(p), k)
    jd, jidx = jn.knn(_j(q), _j(p), k)
    assert idx.shape == (2, 20, k) and idx.dtype == torch.int64
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=OPS_TOL)
    if m < k:
        assert torch.equal(idx[..., m:], idx[..., m - 1:m].expand(-1, -1, k - m))


def test_knn_takes_the_lower_index_on_ties(rng):
    p = rng.randn(1, 12, 3).astype(np.float32)
    p[0, 7] = p[0, 2]
    p[0, 10] = p[0, 2]
    q = p[:, [2, 5]]
    _, idx = tn.knn(_t(q), _t(p), 4)
    _, jidx = jn.knn(_j(q), _j(p), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx[0, 0, :3].tolist() == [2, 7, 10]


@pytest.mark.parametrize("with_features, include", [(True, True), (True, False),
                                                     (False, True), (False, False)])
def test_ball_group_matches_reference(rng, with_features, include):
    pts = rng.rand(2, 80, 3).astype(np.float32)
    centers = pts[:, :10] + 0.01
    feats = rng.randn(2, 80, 5).astype(np.float32) if with_features else None
    got = tn.ball_group(_t(centers), _t(pts), None if feats is None else _t(feats), 0.2, 12,
                        include_coordinates=include)
    want = jn.ball_group(_j(centers), _j(pts), None if feats is None else _j(feats), 0.2, 12,
                         include_coordinates=include)
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=OPS_TOL)


def test_three_nn_interpolate_matches_reference(rng):
    dense = rng.randn(2, 64, 3).astype(np.float32)
    coarse = rng.randn(2, 16, 3).astype(np.float32)
    coarse[:, 0] = dense[:, 0]  # a target on a source: the 1e-10 floor
    feats = rng.randn(2, 16, 7).astype(np.float32)
    got = tn.three_nn_interpolate(_t(dense), _t(coarse), _t(feats))
    want = np.asarray(jn.three_nn_interpolate(_j(dense), _j(coarse), _j(feats)))
    assert got.shape == (2, 64, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=OPS_TOL)
    np.testing.assert_allclose(got[:, 0].numpy(), feats[:, 0], rtol=1e-5, atol=OPS_TOL)


@pytest.mark.parametrize("include", [True, False])
def test_pointnet_a_module_matches_reference(rng, include):
    coords = rng.randn(2, 48, 3).astype(np.float32)
    feats = rng.randn(2, 48, 6).astype(np.float32)
    jm = JaxA(mlp=(16, 32), include_coordinates=include)
    v = _weights(jm, feats, coords)
    tm = _port(PointNetAModule(6, (16, 32), include_coordinates=include), v)
    _close(tm(_t(feats), _t(coords)), jm.apply(v, _j(feats), _j(coords)))


def test_pointnet_sa_module_matches_reference(rng):
    """Two radii (multi-scale): furthest-point centers, then each branch's
    grouping, MLP and max; the centers equal."""
    coords = rng.rand(2, 96, 3).astype(np.float32)
    feats = rng.randn(2, 96, 4).astype(np.float32)
    kw = dict(num_centers=16, radii=(0.15, 0.3), num_neighbors=(8, 16), mlps=((8, 16), (16,)))
    jm = JaxSA(**kw)
    v = _weights(jm, feats, coords)
    tm = _port(PointNetSAModule(4, **kw), v)
    got, centers = tm(_t(feats), _t(coords))
    want, jcenters = jm.apply(v, _j(feats), _j(coords))
    assert got.shape == (2, 16, 32)
    np.testing.assert_array_equal(centers.numpy(), np.asarray(jcenters))
    _close(got, want)


@pytest.mark.parametrize("skip", [True, False])
def test_pointnet_fp_module_matches_reference(rng, skip):
    dense = rng.randn(2, 40, 3).astype(np.float32)
    coarse = dense[:, ::4] + 0.01
    coarse_f = rng.randn(2, 10, 8).astype(np.float32)
    dense_f = rng.randn(2, 40, 3).astype(np.float32) if skip else None
    jm = JaxFP(mlp=(16, 8))
    args = (dense, coarse, coarse_f) + ((dense_f,) if skip else ())
    v = _weights(jm, *args)
    tm = _port(PointNetFPModule(8 + (3 if skip else 0), (16, 8)), v)
    _close(tm(*map(_t, args)), jm.apply(v, *map(_j, args)))


def test_pointnet_matches_reference(rng):
    x = rng.randn(4, 32, 3).astype(np.float32)
    jm = JaxPointNet(blocks=(16, 32), cloud_features=(24, 8))
    v = _weights(jm, x)
    tm = _port(PointNet(3, blocks=(16, 32), cloud_features=(24, 8)), v)
    _close(tm(_t(x)), jm.apply(v, _j(x)))


def _pin(aligned, xp):
    """Each axis signed so its third moment is >= 0 (the two pca_align's
    signs are each eigensolver's own)."""
    return aligned * xp.where((aligned ** 3).sum(-2, keepdims=True) >= 0, 1.0, -1.0)


@pytest.mark.parametrize("rot_invariant", ["pca", None])
def test_pointnet_classifier_matches_reference(rng, monkeypatch, rot_invariant):
    """Logits in eval mode, with pca_align's axis signs pinned alike in
    both packages; in train mode the dropout mask comes from the
    generator, and without one it refuses."""
    monkeypatch.setattr(j_pointnet, "pca_align", lambda c: _pin(j_pca_align(c), jnp))
    monkeypatch.setattr(t_pointnet, "pca_align", lambda c: _pin(pca_align(c), torch))
    x = (rng.randn(4, 64, 3) * [1.0, 0.6, 0.3]).astype(np.float32)
    x[:, :20, 0] += 0.7
    jm = JaxPointNetClassifier(mlp=(16, 32), num_classes=10, rot_invariant=rot_invariant)
    v = _weights(jm, x)
    tm = _port(PointNetClassifier(3, mlp=(16, 32), num_classes=10, rot_invariant=rot_invariant),
               v)
    _close(tm(_t(x)), jm.apply(v, _j(x)))
    tm.train()
    gen = torch.Generator()
    a = tm(_t(x), generator=gen.manual_seed(3))
    b = tm(_t(x), generator=gen.manual_seed(3))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="Generator"):
        tm(_t(x))
