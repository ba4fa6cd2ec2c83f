"""rift_tpu_torch's rotation-invariant preprocesses against rift_tpu's on
the CPU: `new_ppf` (its median of an even count the mean of the two
middle values), `pca_align` up to the sign of each axis, and the
classifier and the segmentation model under 'ppf', 'new_ppf', 'pca' and
None (`tests/test_models.py` is the reference's own twin), with the flip
hypotheses of the registration evaluation off for all four."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rift_tpu.models.pvcnn as j_pvcnn
import rift_tpu.models.shapenet as j_shapenet
import rift_tpu_torch.models.pvcnn as t_pvcnn
from rift_tpu.models import PVCNNClassifier as JaxPVCNN
from rift_tpu.models import ShapeNetPVCNN as JaxShapeNetPVCNN
from rift_tpu.ops.lrf import pca_align as j_pca_align
from rift_tpu.ops.ppf import new_ppf as j_new_ppf
from rift_tpu_torch.models import PVCNNClassifier, ShapeNetPVCNN
from rift_tpu_torch.ops.lrf import pca_align
from rift_tpu_torch.ops.ppf import new_ppf
from rift_tpu_torch.train.config import EvalConfig
from rift_tpu_torch.train.loop import uses_flips
from rift_tpu_torch.weights import from_flax, from_flax_shapenet

TINY_BLOCKS = ((8, 1, 4), (16, 1, None))
MODES = ["ppf", "new_ppf", "pca", None]
# new_ppf against the reference: the same f32 arithmetic in another order;
# the angles' median is an order statistic, continuous in its inputs.
NEW_PPF_ATOL = 2e-5
# pca_align: the 3x3 scatter matrix's eigenvectors by the closed form
# (ops/eig3.py) against LAPACK's, on clouds whose eigenvalues are well
# apart; coordinates up to ~2.
PCA_ATOL = 5e-5
# Model outputs against the reference's, relative to the largest: the
# preprocesses have no neighbour search, so only f32 rounding differs,
# through the voxel binning's boundaries (a one-ulp move of a point).
MODEL_RTOL, MODEL_SHARE = 1e-4, 0.02


def _clouds(rng, b: int, n: int) -> np.ndarray:
    """Anisotropic clouds with unit normals: [b, n, 6]."""
    pts = rng.randn(b, n, 3) * [1.0, 0.6, 0.3]
    pts[:, : n // 3, 0] += 0.7  # a skewed first axis
    nrm = rng.randn(b, n, 3) + [0.0, 0.0, 2.0]  # a mean normal well away from 0
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return np.concatenate([pts, nrm], -1).astype(np.float32)


@pytest.mark.parametrize("n", [64, 65])
def test_new_ppf_matches_reference(rng, n):
    x = _clouds(rng, 3, n)
    got = new_ppf(torch.from_numpy(x[..., :3]), torch.from_numpy(x[..., 3:])).numpy()
    want = np.asarray(j_new_ppf(jnp.asarray(x[..., :3]), jnp.asarray(x[..., 3:])))
    assert got.shape == want.shape == (3, n, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=NEW_PPF_ATOL)


def test_new_ppf_median_of_an_even_count_averages_the_middle_pair(rng):
    """The last channel against the median taken in numpy (f64) from the
    same definition: the projection with the unnormalised mean normal, the
    self-angle (0) counted as 100; at an even n it lies between two of the
    angles, which torch.median (the lower one) would miss."""
    n = 40
    x = _clouds(rng, 1, n)[0].astype(np.float64)
    pts, nrm = x[:, :3], x[:, 3:] / np.linalg.norm(x[:, 3:], axis=1, keepdims=True)
    cn = nrm.mean(0)
    c = pts - pts.mean(0)
    proj = c - (c @ (cn / np.linalg.norm(cn)))[:, None] * cn
    cos = proj @ proj.T
    sin = np.linalg.norm(np.cross(proj[:, None], proj[None, :]), axis=-1)
    alpha = np.arctan2(sin, cos)
    alpha[alpha <= 1e-5] = 100.0
    want = np.median(alpha, axis=1)
    got = new_ppf(torch.from_numpy(x[None, :, :3]).float(),
                  torch.from_numpy(x[None, :, 3:]).float())[0, :, 4].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=NEW_PPF_ATOL)
    lower = np.sort(alpha, axis=1)[:, n // 2 - 1]
    assert np.abs(want - lower).max() > 100 * NEW_PPF_ATOL


def test_pca_align_matches_reference_up_to_axis_signs(rng):
    x = _clouds(rng, 4, 200)[..., :3] + [3.0, -1.0, 0.5]
    got = pca_align(torch.from_numpy(x)).numpy()
    want = np.asarray(j_pca_align(jnp.asarray(x)))
    sign = np.sign((got * want).sum(1, keepdims=True))  # [b, 1, 3]
    assert np.all(np.abs(sign) == 1)
    np.testing.assert_allclose(got * sign, want, rtol=0, atol=PCA_ATOL)
    # Descending variance along the axes, centred.
    var = (got ** 2).mean(1)
    assert np.all(var[:, 0] > var[:, 1]) and np.all(var[:, 1] > var[:, 2])
    np.testing.assert_allclose(got.mean(1), 0.0, atol=1e-5)


def _pin(aligned, xp):
    """Each axis of an aligned cloud signed so its third moment is >= 0:
    the convention both packages' pca_align are held to in the model tests
    (each package's own signs are its eigensolver's)."""
    m3 = (aligned ** 3).sum(-2, keepdims=True)
    return aligned * xp.where(m3 >= 0, 1.0, -1.0)


@pytest.fixture
def pinned_pca(monkeypatch):
    monkeypatch.setattr(j_pvcnn, "pca_align", lambda c: _pin(j_pca_align(c), jnp))
    monkeypatch.setattr(j_shapenet, "pca_align", lambda c: _pin(j_pca_align(c), jnp))
    monkeypatch.setattr(t_pvcnn, "pca_align", lambda c: _pin(pca_align(c), torch))


def _held(got: np.ndarray, want: np.ndarray) -> None:
    err = np.abs(got - want).reshape(got.shape[0], -1, got.shape[-1]).max(-1)
    err = err / np.abs(want).max()
    assert (err > MODEL_RTOL).mean() <= MODEL_SHARE, (err > MODEL_RTOL).mean()
    assert np.median(err) < 1e-5


def _jax_weights(jmodel, x):
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    return jax.tree_util.tree_map(np.asarray, variables)


@pytest.mark.parametrize("mode", MODES)
def test_classifier_preprocess_matches_reference(rng, pinned_pca, mode):
    """Logits of the classifier (no local branch, as tests/test_models.py
    builds it) and the per-point features of its trunk as a feature
    extractor, on the same weights."""
    x = _clouds(rng, 2, 64)
    cfg = dict(blocks=TINY_BLOCKS, num_classes=10, rot_invariant_preprocess=mode,
               with_local_feat=None, point_kernel_formal="dgcnn_kernel")
    jmodel = JaxPVCNN(**cfg, is_classify=True)
    v = _jax_weights(jmodel, x)
    trunk = {c: {k: a for k, a in tree.items() if not k.startswith(("Dense", "BatchNorm"))}
             for c, tree in v.items()}
    for is_classify, variables in ((True, v), (False, trunk)):
        want = np.asarray(JaxPVCNN(**cfg, is_classify=is_classify).apply(variables,
                                                                         jnp.asarray(x)))
        model = PVCNNClassifier(**cfg, is_classify=is_classify)
        model.load_state_dict(from_flax(variables["params"], variables["batch_stats"]))
        with torch.no_grad():
            got = model.eval()(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == ((2, 10) if is_classify else (2, 64, 16))
        if is_classify:
            np.testing.assert_allclose(got, want, rtol=0, atol=MODEL_RTOL * np.abs(want).max())
        else:
            _held(got, want)
    assert not uses_flips(model, EvalConfig(flip_hypotheses=True))


@pytest.mark.parametrize("mode", MODES)
def test_seg_model_preprocess_matches_reference(rng, pinned_pca, mode):
    x = np.concatenate([_clouds(rng, 2, 64), np.eye(16, dtype=np.float32)[[3, 11]][:, None]
                        .repeat(64, 1)], -1)
    cfg = dict(blocks=TINY_BLOCKS, rot_invariant_preprocess=mode, with_local_feat=False)
    jmodel = JaxShapeNetPVCNN(**cfg)
    v = _jax_weights(jmodel, x)
    want = np.asarray(jmodel.apply(v, jnp.asarray(x)))
    model = ShapeNetPVCNN(**cfg)
    model.load_state_dict(from_flax_shapenet(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 64, 50)
    _held(got, want)


def test_preprocesses_that_need_normals_refuse_clouds_without_them(rng):
    x = torch.from_numpy(_clouds(rng, 1, 32)[..., :3])
    for mode in ("ppf", "new_ppf"):
        with pytest.raises(ValueError, match="normals"):
            PVCNNClassifier(blocks=TINY_BLOCKS, rot_invariant_preprocess=mode,
                            with_local_feat=None).eval()(x)
    with pytest.raises(ValueError, match="unknown rot_invariant_preprocess"):
        PVCNNClassifier(rot_invariant_preprocess="lrf")
    pca = PVCNNClassifier(blocks=TINY_BLOCKS, rot_invariant_preprocess="pca",
                          with_local_feat=None, is_classify=False).eval()
    with torch.no_grad():
        assert pca(x).shape == (1, 32, 16)
