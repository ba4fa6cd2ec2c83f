"""The model variants of rift_tpu_torch's PVCNN against rift_tpu's on the
CPU: `ops/lrf.py:local_lrf`; small models with the local features 'fpfh'
and 'change_coords' and with `with_transform_fine_tune` (under 'ppf' and
'fpfh') from a flax init converted by `weights.from_flax` (trunk
features, logits, one train step against `make_train_step`); the fuser of
a bf16 model staying f32; a fine-tune checkpoint through the registration
extractor; and `cli train` / `cli evaluate` with `model.with_local_feat=
fpfh`.

Two traits of the reference decide the inputs (ROADMAP §3):
- FPFH counts a point as its own neighbour where its d² to itself rounds
  above 1e-12, and the two packages centre a cloud to different ulps, so
  the model tests' clouds lie on a 2^-8 grid with a coordinate sum of
  exactly 0: the centring is exact, every d² is exact, and both packages
  see one neighbour list (tests/test_torch_fpfh.py holds FPFH itself on
  any list, self-counting entries included).
- `local_lrf` of a neighbourhood of two distinct points (a centre with two
  neighbours in the radius, the rest `ball_query`'s padding) is collinear:
  its base_y is the rounding residue of x − x, normalized, so either
  package's frame is decided by rounding. The ellipsoid of
  tests/test_torch_model.py has such neighbourhoods at 10% of its points
  at n = 128 and at 0.3% at n = 512, so the model tests run at n = 512,
  and so does the 'change_coords' train step."""
import dataclasses
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.models import PVCNNClassifier as JaxPVCNN
from rift_tpu.ops.lrf import local_lrf as j_local_lrf
from rift_tpu.ops.normals import estimate_normals
from rift_tpu.train.config import ModelConfig as JaxModelConfig
from rift_tpu.train.loop import build_model as jax_build_model
from rift_tpu.train.steps import create_state as jax_create_state
from rift_tpu.train.steps import cross_entropy as jax_cross_entropy
from rift_tpu.train.steps import make_train_step
from rift_tpu_torch import cli
from rift_tpu_torch.data.modelnet40 import ModelNet40
from rift_tpu_torch.models import PVCNNClassifier
from rift_tpu_torch.ops.lrf import local_lrf
from rift_tpu_torch.train import build_model, resolve_extractor
from rift_tpu_torch.train.checkpoint import CheckpointManager
from rift_tpu_torch.train.steps import TrainState, make_optimizer, train_step
from rift_tpu_torch.weights import from_flax
from chip_smoke import on_grid as _on_grid
from test_torch_model import _compare, _perturb, _perturb_stats
from test_torch_train import (GRAD_FLOOR, GRAD_RTOL, GRAD_ZERO_TOL, LOSS_RTOL, SETTLED,
                              SETTLED_PARAM_TOL, STATS_TOL, _no_dropout, _np, _sync,
                              _tiny_configs)

VARIANTS = {"fpfh": dict(with_local_feat="fpfh"),
            "change_coords": dict(with_local_feat="change_coords"),
            "ppf_fine_tune": dict(with_local_feat="ppf", with_transform_fine_tune=True),
            "fpfh_fine_tune": dict(with_local_feat="fpfh", with_transform_fine_tune=True)}
SMALL = dict(blocks=((16, 1, 8), (32, 1, None)), dim_k=32, num_classes=5,
             point_kernel_formal="pointnet_kernel", lrf_kind="pca", local_neighbors=16)


def _grid_inputs(rng, b, n):
    """tests/test_torch_model.py's noisy ellipsoid on the grid, with the
    reference's normals: [b, n, 6]."""
    u = rng.uniform(0, 2 * np.pi, (b, n))
    v = rng.uniform(0.05, np.pi - 0.05, (b, n))
    pts = np.stack([np.sin(v) * np.cos(u), 0.7 * np.sin(v) * np.sin(u), 0.5 * np.cos(v)], -1)
    pts[:, : n // 4, 0] += 0.6
    pts = _on_grid(pts + 0.005 * rng.randn(*pts.shape))
    nrm = np.asarray(estimate_normals(jnp.asarray(pts), impl="xla"))
    return np.concatenate([pts, nrm], -1).astype(np.float32)


def _points(variant):
    return 512 if VARIANTS[variant]["with_local_feat"] == "change_coords" else 256


def _reference_weights(jax_model, x, rng):
    variables = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    return (_perturb(variables["params"], rng, -0.05, 0.05),
            _perturb_stats(variables["batch_stats"], rng))


def test_local_lrf_matches_reference(rng):
    """Random neighbourhoods [2, 64, 16, 3] and one whose two farthest
    points are a near-tie in norm (one ulp apart, so rounding may pick
    either as base_x): held by the share of neighbourhoods, as
    tests/test_torch_model.py's _compare holds points. A two-point
    neighbourhood agrees on its x column alone (see the module's note)."""
    nbr = rng.randn(2, 64, 16, 3).astype(np.float32)
    tie = nbr[0, 0]  # a view: edited in place
    tie[2:] = 0.25 * (tie[2:] - tie[2:].mean(0))
    tie[1] = -tie[0] * np.float32(1 - 2 ** -23)  # base_x's rival, nearly as far
    got = local_lrf(torch.from_numpy(nbr)).numpy()
    want = np.asarray(j_local_lrf(jnp.asarray(nbr)))
    err = np.abs(got - want).max((-1, -2)) / np.abs(want).max()
    assert (err > 1e-3).mean() <= 0.01 and np.median(err) < 1e-6, ((err > 1e-3).mean(),
                                                                  np.median(err))
    # Two distinct points as ball_query pads them: the first found 15 times.
    pair = rng.randn(1, 1, 2, 3).astype(np.float32)
    two = np.concatenate([np.repeat(pair[:, :, :1], 15, axis=2), pair[:, :, 1:]], axis=2)
    got = local_lrf(torch.from_numpy(two)).numpy()
    want = np.asarray(j_local_lrf(jnp.asarray(two)))
    np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def clouds():
    """Two grid clouds of 512 points with normals, shared by the model
    tests (one shape: JAX compiles each eager op once)."""
    return _grid_inputs(np.random.RandomState(0), 2, 512)


@pytest.mark.parametrize("variant", VARIANTS)
def test_small_variant_model_matches_reference(rng, clouds, variant):
    """The classifier of each variant from a perturbed flax init converted
    by from_flax, which maps every leaf of it (the fine-tune block's under
    `fine_tune.`): its trunk features (the last backbone layer's output)
    by _compare, its logits within 1e-4 of the largest."""
    kw = VARIANTS[variant]
    fine_tune = kw.get("with_transform_fine_tune", False)
    cfg = dict(SMALL, **kw, is_classify=True)
    jax_model = JaxPVCNN(**cfg)
    params, stats = _reference_weights(jax_model, clouds, rng)
    want, seen = jax_model.apply({"params": params, "batch_stats": stats},
                                 jnp.asarray(clouds), train=False, capture_intermediates=True)
    model = PVCNNClassifier(**cfg)
    state = from_flax(params, stats, fine_tune=fine_tune)
    model.load_state_dict(state)  # strict
    assert any(k.startswith("fine_tune.") for k in state) == fine_tune
    last = model._backbone[-1]
    want_feat = np.asarray(seen["intermediates"][last]["__call__"][0])
    got_feat = {}
    model.layers[last].register_forward_hook(lambda m, a, out: got_feat.setdefault("f", out))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(clouds)).numpy()
    assert got_feat["f"].shape == want_feat.shape == (2, 512, 32)
    _compare(got_feat["f"].numpy(), want_feat)
    want = np.asarray(want)
    assert got.shape == want.shape == (2, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_train_step_matches_make_train_step(variant):
    """One train step of tiny_smoke with the variant's fields, dropout off,
    from the reference's init, on 4 of its clouds put on the grid: loss,
    every gradient, BN statistics and the updated parameters by
    tests/test_torch_train.py's rules."""
    kw = VARIANTS[variant]
    fine_tune = kw.get("with_transform_fine_tune", False)
    cfg, jcfg = _tiny_configs()
    for k, v in kw.items():
        setattr(cfg.model, k, v)
    cfg.dataset.num_points = _points(variant)
    jcfg.model = JaxModelConfig(**dataclasses.asdict(cfg.model))
    clouds, labels = next(ModelNet40(cfg.dataset, "train").batches(cfg.train.batch_size, seed=0))
    clouds = np.concatenate([_on_grid(clouds[..., :3]), clouds[..., 3:]], -1)
    jmodel = jax_build_model(jcfg)
    jstate, tx = jax_create_state(jmodel, jcfg, jnp.asarray(clouds), 8)
    x, y = jnp.asarray(clouds), jnp.asarray(labels)

    @jax.jit  # as test_torch_train computes them: jitted, the inputs as arguments
    def jax_grads(params, stats, x, y):
        def loss_fn(p):
            out, _ = jmodel.apply({"params": p, "batch_stats": stats}, x, train=True,
                                  mutable=["batch_stats"])
            return jax_cross_entropy(out, y)
        return jax.grad(loss_fn)(params)

    with fnn.intercept_methods(_no_dropout):
        jgrads = from_flax(_np(jax_grads(jstate.params, jstate.batch_stats, x, y)),
                           _np(jstate.batch_stats), fine_tune=fine_tune)
        after, metrics = make_train_step(jmodel, tx)(jstate, x, y, jax.random.PRNGKey(0))
    want = from_flax(_np(after.params), _np(after.batch_stats), fine_tune=fine_tune)
    model = build_model(cfg)
    model.dropout = 0.0
    state = TrainState(model, *make_optimizer(model, cfg, 8))
    _sync(state, jstate, fine_tune=fine_tune)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    out = train_step(state, torch.from_numpy(clouds), torch.from_numpy(labels))
    np.testing.assert_allclose(float(out["loss"]), float(metrics["loss"]), rtol=LOSS_RTOL)
    grads = dict(model.named_parameters())
    assert set(grads) <= set(jgrads)
    top = max(float(g.norm()) for g in jgrads.values())
    for name, p in grads.items():
        err = float((p.grad - jgrads[name]).norm())
        if float(jgrads[name].norm()) >= GRAD_FLOOR * top:
            assert err <= GRAD_RTOL * float(jgrads[name].norm()), \
                (name, err / float(jgrads[name].norm()))
        else:
            assert err <= GRAD_ZERO_TOL * top, (name, err / top)
    got = model.state_dict()
    scale = max(float(want[k].abs().max()) for k in got if "running" in k)
    for name in got:
        if "running" in name:
            assert float((got[name] - want[name]).abs().max()) <= STATS_TOL * scale, name
    # The updated parameters by test_torch_train's SETTLED rule, on the
    # gradient Adam reads: g + weight_decay·p. Where the two nearly cancel
    # (g of 8.4e-8 on a weight of -0.083 in a ppf_fine_tune run), a 1%
    # agreement of g is none of their sum, and Adam's first step,
    # lr·G/(|G| + 1e-8), parts by 0.04 lr.
    lr, wd = state.schedule(0), cfg.optim.weight_decay
    for name, p in grads.items():
        off = (p.detach() - want[name]).abs()
        g_ref = jgrads[name] + wd * before[name]
        settled = (p.grad + wd * before[name] - g_ref).abs() <= SETTLED * g_ref.abs()
        assert float(torch.where(settled, off, 0.0).max()) <= SETTLED_PARAM_TOL, name
        assert float(off.max()) <= 2.1 * lr, (name, float(off.max()) / lr)
    if fine_tune:  # the block trains: its gradients are not all zero
        assert any(float(grads[k].grad.norm()) > 0 for k in grads if k.startswith("fine_tune."))


def test_bf16_model_keeps_the_fpfh_fuser_and_the_fine_tune_in_f32(rng, clouds):
    """In a dtype='bfloat16' model the FPFH fuser and the fine-tune block
    are built without the model's dtype, as the reference's: f32 outputs
    beside the bf16 backbone MLP's; the forward matches the reference's bf16
    model within the bf16 rule of tests/test_torch_model.py's bench test."""
    cfg = dict(SMALL, with_local_feat="fpfh", with_transform_fine_tune=True, dtype="bfloat16",
               is_classify=False)
    x = clouds
    jax_model = JaxPVCNN(**cfg)
    params, stats = _reference_weights(jax_model, x, rng)
    want = np.asarray(jax_model.apply({"params": params, "batch_stats": stats},
                                      jnp.asarray(x), train=False))
    model = PVCNNClassifier(**cfg)
    model.load_state_dict(from_flax(params, stats, fine_tune=True))
    seen = {}
    for name in ("SharedMLP_1", "SharedMLP_2"):
        model.layers[name].register_forward_hook(
            lambda m, args, out, name=name: seen.__setitem__(name, out.dtype))
    model.fine_tune["Dense_1"].register_forward_hook(
        lambda m, args, out: seen.__setitem__("fine_tune", out.dtype))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert model.layers["SharedMLP_1"].dtype is None and model.fine_tune["SharedMLP_0"].dtype is None
    assert seen == {"SharedMLP_1": torch.float32, "fine_tune": torch.float32,
                    "SharedMLP_2": torch.bfloat16}
    ulp = 2.0 ** -8 * np.abs(want).max()
    err = np.abs(got - want).max(-1)
    assert err.max() <= 4 * ulp, err.max() / ulp
    assert np.median(err) <= 2 * ulp, np.median(err) / ulp


def test_fine_tune_weights_survive_the_registration_extractor(rng, clouds, tmp_path):
    """A fine-tune classifier of tiny_smoke converted from the reference's
    init and saved as a port checkpoint: `resolve_extractor` (its snapshot
    through extractor_from_snapshot, then the `head.` filter) loads the
    fine-tune block, and the extractor's features are the reference's
    trunk's on the same weights (canonical voxels, as the evaluation)."""
    cfg, jcfg = _tiny_configs()
    cfg.model.with_transform_fine_tune = True
    cfg.train.ckpt_dir = str(tmp_path)
    jcfg.model = JaxModelConfig(**dataclasses.asdict(cfg.model))
    x = clouds
    params, stats = _reference_weights(jax_build_model(jcfg), x, rng)
    state = from_flax(params, stats, fine_tune=True)
    classifier = build_model(cfg)
    classifier.load_state_dict(state)
    CheckpointManager(str(tmp_path)).save_common(
        TrainState(classifier, *make_optimizer(classifier, cfg, 1)), {}, cfg)
    extractor = resolve_extractor(cfg, device="cpu")
    assert extractor.head is None and extractor.use_new_coords_for_voxel
    loaded = extractor.state_dict()
    ft = [k for k in state if k.startswith("fine_tune.")]
    assert len(ft) == 2 * 6 + 2 + 4 + 2 and not any(k.startswith("head.") for k in loaded)
    for k in ft:
        assert torch.equal(loaded[k], state[k]), k
    head = {"Dense_2", "Dense_3", "Dense_4", "BatchNorm_1", "BatchNorm_2"}
    trunk = jax_build_model(dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, is_classify=False, use_new_coords_for_voxel=True)))
    want = np.asarray(trunk.apply(
        {"params": {k: v for k, v in params.items() if k not in head},
         "batch_stats": {k: v for k, v in stats.items() if k not in head}},
        jnp.asarray(x), train=False))
    with torch.no_grad():
        got = extractor(torch.from_numpy(x)).numpy()
    _compare(got, want)


def test_cli_trains_and_evaluates_the_fpfh_variant(tmp_path, capsys):
    """`cli train --preset tiny_smoke model.with_local_feat=fpfh` writes a
    checkpoint whose snapshot names the variant, and `cli evaluate --ckpt`
    restores it as an FPFH extractor and prints the six result lines."""
    ckpt = str(tmp_path / "run")
    assert cli.main(["train", "--preset", "tiny_smoke", "--device", "cpu", "--no-resume",
                     f"train.ckpt_dir={ckpt}", "optim.num_epochs=1", "train.steps_per_epoch=2",
                     "model.with_local_feat=fpfh"]) == 0
    with open(os.path.join(ckpt, "common.meta.json")) as f:
        assert json.load(f)["config"]["model"]["with_local_feat"] == "fpfh"
    capsys.readouterr()
    assert cli.main(["evaluate", "--preset", "tiny_smoke", "--device", "cpu", "--ckpt", ckpt,
                     "evaluate.num_points=128", "evaluate.num_pairs=2"]) == 0
    lines = [line.split(": ") for line in capsys.readouterr().out.strip().splitlines()]
    results = {k: float(v) for k, v in lines}
    assert list(results) == ["rre", "rte", "rmse", "succ", "rmse_succ", "reg_time"]
    assert all(np.isfinite(list(results.values())))
    cfg, _ = _tiny_configs()
    model = resolve_extractor(cfg, ckpt_dir=ckpt, device="cpu")
    assert model.with_local_feat == "fpfh"
    assert model.layers[model._local].layers[0]["dense"].in_features == 33
