"""rift_tpu_torch's cube voxel path against rift_tpu's on the same numpy
inputs: `normalize_coords_cube` (both branches), `cube_voxel_indices`,
`avg_voxelize` and `trilinear_devoxelize` on clouds with points on both
faces of the grid and exactly on cell boundaries, their gradients against
`jax.vjp`, and a cube `PVConv` (both point branches, f32 and bf16) and a
small cube model converted by `weights.from_flax`. The checkpoints' cube
trunks are in tests/test_torch_cube_ckpt.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.models import PVCNNClassifier as JaxPVCNN
from rift_tpu.nn.pvconv import PVConv as JaxPVConv
from rift_tpu.ops import voxelize as jv
from rift_tpu.ops.normals import estimate_normals
from rift_tpu_torch.models import PVCNNClassifier
from rift_tpu_torch.nn import PVConv
from rift_tpu_torch.ops import voxelize as tv
from rift_tpu_torch.weights import from_flax

R = 8


def _boundary_cloud(rng, b, n):
    """Clouds [b, n, 3] whose mean is exactly 0 (each point with its
    negation; every coordinate a multiple of 1/16, so the sums are exact):
    with normalize=False the grid coordinate 4c + 4 (r = 8) is an integer
    (a cell boundary) or a half (a rounding tie) for most points, and the
    points at |c| >= 1 sit on the faces or clamp to them."""
    half = rng.randint(-20, 21, (b, n // 2, 3)).astype(np.float32) / 16.0
    half[:, 0] = 1.0     # on the upper face of every axis: grid coord r
    half[:, 1] = 1.25    # past it: clamped to r - 1
    half[:, 2] = 0.875   # grid coord r - 0.5: a tie, rounded to even
    return np.concatenate([half, -half], 1)


def _random_cloud(rng, b, n):
    return rng.uniform(-1.3, 1.3, (b, n, 3)).astype(np.float32)


CLOUDS = {"boundary": _boundary_cloud, "random": _random_cloud}


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_cube_voxelize_matches_reference(rng, normalize, cloud):
    b, n, c = 2, 160, 5
    coords = CLOUDS[cloud](rng, b, n)
    feat = rng.randn(b, n, c).astype(np.float32)
    want_g = np.asarray(jv.normalize_coords_cube(jnp.asarray(coords), R, normalize))
    got_g = tv.normalize_coords_cube(torch.from_numpy(coords), R, normalize).numpy()
    # The mean and the largest radius are sums in another order: 1 ulp at
    # the grid's scale.
    np.testing.assert_allclose(got_g, want_g, rtol=0, atol=1e-6)
    if cloud == "boundary" and not normalize:
        np.testing.assert_array_equal(got_g, want_g)  # exact sums: equal
        assert (got_g == R - 1).any() and (got_g == 0).any()
        assert (got_g == np.round(got_g)).mean() > 0.2
        assert (np.abs(got_g - np.floor(got_g) - 0.5) == 0).any()
    np.testing.assert_array_equal(
        tv.cube_voxel_indices(torch.from_numpy(np.array(want_g)), R).numpy(),
        np.asarray(jv.cube_voxel_indices(jnp.asarray(want_g), R)))
    w_grid, w_inds, w_coords = jv.avg_voxelize(jnp.asarray(feat), jnp.asarray(coords), R,
                                               normalize=normalize)
    g_grid, g_inds, g_coords = tv.avg_voxelize(torch.from_numpy(feat), torch.from_numpy(coords),
                                               R, normalize=normalize)
    np.testing.assert_allclose(g_coords.numpy(), np.asarray(w_coords), rtol=0, atol=1e-6)
    if cloud == "boundary":
        np.testing.assert_array_equal(g_inds.numpy(), np.asarray(w_inds))
    else:  # a grid coordinate 1 ulp from a rounding tie may round apart
        assert (g_inds.numpy() != np.asarray(w_inds)).mean() <= 0.01
    assert g_grid.shape == (b, R, R, R, c)
    # K2 sums a voxel's features then scales; the reference scales each.
    np.testing.assert_allclose(g_grid.numpy(), np.asarray(w_grid), rtol=0, atol=1e-6)


@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_cube_devoxelize_matches_reference(rng, cloud):
    b, n, c = 2, 160, 6
    grid_coords = np.array(jv.normalize_coords_cube(
        jnp.asarray(CLOUDS[cloud](rng, b, n)), R, normalize=False))
    grid = rng.randn(b, R, R, R, c).astype(np.float32)
    want = np.asarray(jv.trilinear_devoxelize(jnp.asarray(grid), jnp.asarray(grid_coords), R))
    got = tv.trilinear_devoxelize(torch.from_numpy(grid), torch.from_numpy(grid_coords), R)
    # The same 8 corners and weights, summed in the same order.
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    idx, w = tv.cube_corner_weights(torch.from_numpy(grid_coords), R)
    assert int(idx.min()) >= 0 and int(idx.max()) < R ** 3
    torch.testing.assert_close(w.sum(-1), torch.ones(b, n), rtol=0, atol=1e-6)
    on_face = torch.from_numpy(grid_coords) == R - 1
    assert bool(on_face.any())  # hi == lo there, with the weight on lo


def test_cube_gradients_match_jax_vjp(rng):
    """The scatter-mean's backward (K2's row gather) and the devoxelize's
    (K4, through CornerGather) against jax.vjp of the reference's."""
    b, n, c = 2, 160, 4
    coords = _boundary_cloud(rng, b, n)
    feat = rng.randn(b, n, c).astype(np.float32)
    g_out = rng.randn(b, R, R, R, c).astype(np.float32)
    want_grid, vjp = jax.vjp(lambda f: jv.avg_voxelize(f, jnp.asarray(coords), R,
                                                       normalize=False)[0], jnp.asarray(feat))
    (want_df,) = vjp(jnp.asarray(g_out))
    f = torch.from_numpy(feat).requires_grad_()
    grid, _, grid_coords = tv.avg_voxelize(f, torch.from_numpy(coords), R, normalize=False)
    grid.backward(torch.from_numpy(g_out))
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(want_df), rtol=0, atol=1e-6)

    vox = rng.randn(b, R, R, R, c).astype(np.float32)
    d_out = rng.randn(b, n, c).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jv.trilinear_devoxelize(v, jnp.asarray(grid_coords.numpy()), R),
                     jnp.asarray(vox))
    (want_dv,) = vjp(jnp.asarray(d_out))
    v = torch.from_numpy(vox).requires_grad_()
    tv.trilinear_devoxelize(v, grid_coords, R).backward(torch.from_numpy(d_out))
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(want_dv), rtol=0, atol=1e-5)


def _perturb(tree, rng, lo, hi):
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.uniform(lo, hi, np.shape(a))).astype(np.float32), tree)


def _perturb_stats(tree, rng):
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (np.asarray(a) + (rng.uniform(0.1, 0.5, np.shape(a))
                                          if path[-1].key == "var"
                                          else rng.uniform(-0.05, 0.05, np.shape(a)))
                         ).astype(np.float32), tree)


def _cube_block(rng, kernel, normalize, dtype=None):
    """A cube PVConv of the reference with perturbed weights, its output on
    a boundary cloud, and the port's block loaded by from_flax."""
    b, n, c, out = 2, 160, 7, 16
    feats = rng.randn(b, n, c).astype(np.float32)
    coords = _boundary_cloud(rng, b, n) * 0.8
    jax_block = JaxPVConv(out_channels=out, point_kernel_formal=kernel, voxel_shape="cube",
                          resolution=R, with_coeff=True, with_se=True, normalize=normalize,
                          impl="xla", dtype=None if dtype is None else jnp.bfloat16)
    variables = jax_block.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(coords))
    params = {"PVConv_0": _perturb(variables["params"], rng, -0.05, 0.05)}
    stats = {"PVConv_0": _perturb_stats(variables["batch_stats"], rng)}
    want = np.asarray(jax_block.apply({"params": params["PVConv_0"],
                                       "batch_stats": stats["PVConv_0"]},
                                      jnp.asarray(feats), jnp.asarray(coords))).astype(np.float32)
    block = PVConv(c, out, point_kernel_formal=kernel, voxel_shape="cube", resolution=R,
                   with_coeff=True, with_se=True, normalize=normalize, dtype=dtype)
    prefix = "layers.PVConv_0."
    block.load_state_dict({k[len(prefix):]: v for k, v in from_flax(params, stats).items()})
    with torch.no_grad():
        got = block.eval()(torch.from_numpy(feats), torch.from_numpy(coords)).float().numpy()
    return got, want


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("kernel", ["pointnet_kernel", "dgcnn_kernel"])
def test_cube_pvconv_matches_reference(rng, kernel, normalize):
    got, want = _cube_block(rng, kernel, normalize)
    assert got.shape == want.shape == (2, 160, 16)
    # One block: f32 rounding only (the dgcnn centre is the point's own
    # cube cell, never -1).
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_cube_pvconv_in_bf16_matches_reference(rng):
    """The bf16 branch on the cube grid (K5's plain version on the CPU):
    within the bf16 rule of the bench model's test (both sides round at
    every layer; the reference sums the voxel means in bf16, K2 in f32),
    every point within 4 bf16 steps of the largest output, the median
    within 2."""
    got, want = _cube_block(rng, "dgcnn_kernel", False, dtype=torch.bfloat16)
    ulp = 2.0 ** -8 * np.abs(want).max()
    err = np.abs(got - want).max(-1)
    assert err.max() <= 4 * ulp, err.max() / ulp
    assert np.median(err) <= 2 * ulp, np.median(err) / ulp


@pytest.mark.parametrize("kernel", ["pointnet_kernel", "dgcnn_kernel"])
def test_small_cube_model_matches_reference(rng, kernel):
    """A narrow cube trunk with canonical voxels (the evaluation's forward;
    the model builds its blocks with normalize=False) and global PPF."""
    cfg = dict(blocks=((16, 1, 8), (32, 1, 8), (32, 1, None)), dim_k=32, is_classify=False,
               point_kernel_formal=kernel, voxel_shape="cube", lrf_kind="reference",
               extra_feature_channels=4, local_neighbors=16, with_coeff=True, with_se=True,
               use_new_coords_for_voxel=True)
    u = rng.uniform(0, 2 * np.pi, (2, 192))
    v = rng.uniform(0.05, np.pi - 0.05, (2, 192))
    pts = np.stack([np.sin(v) * np.cos(u), 0.7 * np.sin(v) * np.sin(u), 0.5 * np.cos(v)], -1)
    pts[:, :48, 0] += 0.6
    pts = (pts + 0.005 * rng.randn(*pts.shape)).astype(np.float32)
    x = np.concatenate([pts, np.asarray(estimate_normals(jnp.asarray(pts), impl="xla"))],
                       -1).astype(np.float32)
    jax_model = JaxPVCNN(**cfg)
    variables = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    params = _perturb(variables["params"], rng, -0.05, 0.05)
    stats = _perturb_stats(variables["batch_stats"], rng)
    want = np.asarray(jax_model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                      train=False))
    model = PVCNNClassifier(**cfg)
    assert model.layers["PVConv_0"].cube and not model.layers["PVConv_0"].normalize
    model.load_state_dict(from_flax(params, stats))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 192, 32)
    # As tests/test_torch_model.py's _compare: a one-ulp change in a voxel
    # boundary or a ball-query radius test moves single points.
    err = np.abs(got - want).max(-1) / np.abs(want).max()
    assert (err > 1e-3).mean() <= 0.01, (err > 1e-3).mean()
    assert np.median(err) < 1e-5, np.median(err)
