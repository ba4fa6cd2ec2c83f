"""rift_tpu_torch's ShapeNet part segmentation against rift_tpu's on the
CPU: the ShapeNet items (synthetic, and from a shapenetcore txt tree the
test writes), the instance-mIoU meter, `ShapeNetPVCNN`'s logits at a
narrow width and from the shipped `shapenet_r3` checkpoint (orbax on the
test side only), one segmentation step against the reference's
`seg_step`, and `train_segmentation` (run, checkpoints, resume) against
the reference's at `tiny_smoke` widths."""
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rift_tpu_torch.train.loop as t_loop
from rift_tpu.data.shapenet import ShapeNet as JaxShapeNet
from rift_tpu.data.shapenet import ShapeNetConfig as JaxShapeNetConfig
from rift_tpu.models import ShapeNetPVCNN as JaxShapeNetPVCNN
from rift_tpu.train.loop import train_segmentation as jax_train_segmentation
from rift_tpu.train.meters import MeterShapeNetIoU as JaxMeterShapeNetIoU
from rift_tpu.train.steps import TrainState as JaxTrainState
from rift_tpu.train.steps import make_optimizer as jax_make_optimizer
from rift_tpu_torch.data.shapenet import ShapeNet, ShapeNetConfig
from rift_tpu_torch.models import ShapeNetPVCNN
from rift_tpu_torch.train import build_seg_model, train_segmentation
from rift_tpu_torch.train.checkpoint import CheckpointManager
from rift_tpu_torch.train.meters import MeterShapeNetIoU
from rift_tpu_torch.train.steps import TrainState, make_optimizer, train_step
from rift_tpu_torch.weights import from_flax_shapenet
from test_torch_train import (GRAD_FLOOR, GRAD_RTOL, GRAD_ZERO_TOL, LOSS_RTOL, SETTLED,
                              SETTLED_PARAM_TOL, STATS_TOL, _no_dropout, _np, _sync,
                              _tiny_configs)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG_DIR = os.path.join(ROOT, "checkpoints", "shapenet_r3")
NARROW = dict(blocks=((16, 1, 8), (32, 1, None)), local_neighbors=16, with_local_feat=True)
# Logits against the reference's: a one-ulp difference in a ball-query
# radius test or a voxel boundary moves single points (as for the
# classifier's features, tests/test_torch_model.py:_compare); elsewhere the
# two forwards agree to f32 rounding. At most LOGIT_SHARE of the points
# differ by more than LOGIT_TOL of the largest logit, the median point by
# less than LOGIT_MEDIAN, and the argmax agrees at ARGMAX_SHARE of them.
LOGIT_TOL, LOGIT_SHARE, LOGIT_MEDIAN, ARGMAX_SHARE = 1e-3, 0.01, 1e-5, 0.99


def _items(split: str, n: int, count: int, **kw) -> tuple[np.ndarray, np.ndarray]:
    cfg = ShapeNetConfig(num_points=n, synthetic_items={"train": count, "test": count}, **kw)
    return next(ShapeNet(cfg, split).batches(count, seed=0, shuffle=False))


def _compare_logits(got: np.ndarray, want: np.ndarray) -> None:
    err = np.abs(got - want).max(-1) / np.abs(want).max()
    assert (err > LOGIT_TOL).mean() <= LOGIT_SHARE, (err > LOGIT_TOL).mean()
    assert np.median(err) < LOGIT_MEDIAN, np.median(err)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= ARGMAX_SHARE


@pytest.mark.parametrize("kw", [
    {},
    {"with_normals": False, "jitter": False, "random_rot": {"train": False, "test": True}},
    {"with_one_hot_shape_id": False, "normalize": False},
])
def test_synthetic_shapenet_matches_reference(kw):
    args = dict(num_points=96, synthetic_items={"train": 6, "test": 5}, **kw)
    for split in ("train", "test"):
        ours, ref = ShapeNet(ShapeNetConfig(**args), split), JaxShapeNet(
            JaxShapeNetConfig(**args), split)
        assert len(ours) == len(ref)
        for seed, shuffle in ((0, False), (3, True)):
            got = list(ours.batches(4, seed=seed, shuffle=shuffle, drop_last=False))
            want = list(ref.batches(4, seed=seed, shuffle=shuffle, drop_last=False))
            assert len(got) == len(want) == 2
            for (c1, l1), (c2, l2) in zip(got, want):
                assert c1.dtype == c2.dtype == np.float32 and l1.dtype == l2.dtype
                np.testing.assert_array_equal(c1, c2)
                np.testing.assert_array_equal(l1, l2)


def _write_tree(root, rng) -> None:
    """A shapenetcore_partanno_segmentation_benchmark_v0_normal tree: 3
    shapes, items of 150-300 rows (x y z nx ny nz label), one listed item
    missing and one empty."""
    synsets = ["02691156", "02773838", "02954340"]
    os.makedirs(os.path.join(root, "train_test_split"))
    with open(os.path.join(root, "synsetoffset2category.txt"), "w") as f:
        for name, s in zip(("Airplane", "Bag", "Cap"), synsets):
            f.write(f"{name}\t{s}\n")
    lists = {"train": [], "test": []}
    for i in range(9):
        s = synsets[i % 3]
        os.makedirs(os.path.join(root, s), exist_ok=True)
        name = f"item{i:03d}"
        split = "train" if i < 6 else "test"
        lists[split].append(f"shape_data/{s}/{name}")
        if i == 4:
            continue  # listed, no file
        path = os.path.join(root, s, name + ".txt")
        if i == 5:
            open(path, "w").close()  # listed, empty
            continue
        rows = rng.randint(150, 300)
        pts = rng.randn(rows, 3) * [1.0, 0.5, 0.3]
        nrm = rng.randn(rows, 3)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        lbl = rng.randint(0, 50, rows)
        np.savetxt(path, np.column_stack([pts, nrm, lbl]), fmt="%.6f")
    for split, entries in lists.items():
        with open(os.path.join(root, "train_test_split",
                               f"shuffled_{split}_file_list.json"), "w") as f:
            json.dump(entries, f)


def test_shapenet_txt_layout_matches_reference(tmp_path, rng):
    root = str(tmp_path / "shapenet")
    _write_tree(root, rng)
    for split, count in (("train", 4), ("test", 3)):
        ours = ShapeNet(ShapeNetConfig(root=root, num_points=200), split)
        ref = JaxShapeNet(JaxShapeNetConfig(root=root, num_points=200), split)
        assert len(ours) == len(ref) == count  # the missing and the empty item skipped
        got = list(ours.batches(2, seed=1, drop_last=False))
        want = list(ref.batches(2, seed=1, drop_last=False))
        for (c1, l1), (c2, l2) in zip(got, want):
            np.testing.assert_array_equal(c1, c2)
            np.testing.assert_array_equal(l1, l2)
        assert got[0][0].shape == (2, 200, 22)


@pytest.mark.parametrize("classes, perfect", [(50, False), (4, False), (6, True)])
def test_iou_meter_matches_reference(rng, classes, perfect):
    """Random part labels (all 50, or a few parts so that parts are missing
    from one side), and a perfect prediction: equal to the reference's."""
    ours, ref = MeterShapeNetIoU(), JaxMeterShapeNetIoU()
    for _ in range(3):
        labels = rng.randint(0, classes, (5, 300))
        logits = rng.randn(5, 300, 50)
        if perfect:
            logits[np.arange(5)[:, None], np.arange(300), labels] += 100.0
        else:
            logits[..., classes:] -= 3.0  # predictions mostly among the labels' parts
        ours.update(logits, labels)
        ref.update(logits, labels)
    assert ours.num == ref.num == 15
    assert ours.compute() == ref.compute()
    if perfect:
        assert ours.compute() == 1.0


def _reference_weights(jmodel, x, rng=None, seed: int = 0):
    """The reference's init of `jmodel` on x from `seed` (under jit, as its
    create_state runs it); with `rng`, its parameters and BN statistics
    perturbed (so every layer's statistics matter)."""
    variables = jax.jit(lambda rngs, x: jmodel.init(rngs, x, train=False))(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed + 1)},
        jnp.asarray(x))
    params, stats = _np(variables["params"]), _np(variables["batch_stats"])
    if rng is not None:
        params = jax.tree_util.tree_map(
            lambda a: (a + rng.uniform(-0.05, 0.05, a.shape)).astype(np.float32), params)
        stats = jax.tree_util.tree_map_with_path(
            lambda path, a: (a + (rng.uniform(0.1, 0.5, a.shape) if path[-1].key == "var"
                                  else rng.uniform(-0.05, 0.05, a.shape))).astype(np.float32),
            stats)
    return params, stats


@pytest.mark.parametrize("kw", [
    {},
    {"with_local_feat": False, "point_kernel_formal": "pointnet_kernel"},
    {"blocks": ((8, 2, 8), (16, 1, None), (16, 0, None)), "width_multiplier": 1.5,
     "with_local_feat": False},
])
def test_narrow_seg_model_matches_reference(rng, kw):
    cfg = dict(NARROW, **kw)
    x, _ = _items("test", 128, 2)
    jmodel = JaxShapeNetPVCNN(**cfg)
    params, stats = _reference_weights(jmodel, x, rng)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params, "batch_stats": stats},
                                            jnp.asarray(x)))
    model = ShapeNetPVCNN(**cfg)
    model.load_state_dict(from_flax_shapenet(params, stats))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 128, 50)
    _compare_logits(got, want)


def test_shapenet_r3_checkpoint_matches_reference():
    """The shipped segmentation checkpoint (best mIoU) at full width: the
    preset's model, 2 test clouds of 256 points."""
    from rift_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager

    with open(os.path.join(SEG_DIR, "best_iou.meta.json")) as f:
        meta = json.load(f)["config"]
    raw = JaxCheckpointManager(SEG_DIR).restore_raw("best_iou")
    params, stats = _np(raw["params"]), _np(raw["batch_stats"])
    m = meta["model"]
    kw = dict(blocks=tuple(tuple(b) for b in m["blocks"]),
              point_kernel_formal=m["point_kernel_formal"], voxel_shape=m["voxel_shape"],
              rot_invariant_preprocess=m["rot_invariant_preprocess"],
              with_local_feat=bool(m["with_local_feat"]), local_neighbors=m["local_neighbors"],
              width_multiplier=m["width_multiplier"])
    x, _ = _items("test", 256, 2)
    want = np.asarray(jax.jit(JaxShapeNetPVCNN(**kw).apply)(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)))
    model = ShapeNetPVCNN(**kw)
    model.load_state_dict(from_flax_shapenet(params, stats))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 256, 50)
    _compare_logits(got, want)
    # The converter consumes every key and refuses another model's tree.
    with pytest.raises(ValueError, match="BatchNorm_0"):
        from_flax_shapenet(dict(params, BatchNorm_0=params["SharedMLP_3"]["BatchNorm_0"]),
                           stats)
    with pytest.raises(ValueError, match="SE3d"):
        from_flax_shapenet(dict(params, PVConv_0=dict(params["PVConv_0"], SE3d_0={})), stats)
    with pytest.raises(ValueError, match="Dense_9"):
        from_flax_shapenet(dict(params, SharedMLP_5=dict(
            params["SharedMLP_5"], Dense_9=params["SharedMLP_5"]["Dense_0"])), stats)


def _ref_seg_step(model, tx):
    """The reference's seg_step (rift_tpu/train/loop.py:train_segmentation)."""
    @jax.jit
    def seg_step(state, clouds, labels, rng):
        dropout_rng = jax.random.fold_in(rng, state.step)

        def loss_fn(params):
            out, mutated = model.apply(
                {"params": params, "batch_stats": state.batch_stats}, clouds, train=True,
                mutable=["batch_stats"], rngs={"dropout": dropout_rng})
            logp = jax.nn.log_softmax(out)
            loss = -jnp.mean(jnp.take_along_axis(logp, labels[..., None], axis=-1))
            return loss, mutated["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        updates, new_opt = tx.update(grads, state.opt_state, state.params)
        return state.replace(step=state.step + 1, params=optax.apply_updates(
            state.params, updates), batch_stats=new_stats, opt_state=new_opt), loss, grads

    return seg_step


def test_seg_step_matches_reference_seg_step():
    """Two segmentation steps from the reference's init, dropout off: the
    loss (the mean over all b·n points), every gradient, the BN statistics
    and the updated parameters, by tests/test_torch_train.py's rules."""
    cfg, jcfg = _tiny_configs()
    clouds, labels = _items("train", 64, 4)
    jmodel = JaxShapeNetPVCNN(**NARROW)
    params, stats = _reference_weights(jmodel, clouds)
    tx = jax_make_optimizer(jcfg, 8)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                           opt_state=tx.init(params))
    seg_step = _ref_seg_step(jmodel, tx)
    model = ShapeNetPVCNN(**NARROW)
    model.dropout = 0.0
    state = TrainState(model, *make_optimizer(model, cfg, 8))
    for _ in range(2):
        before = jstate
        with fnn.intercept_methods(_no_dropout):
            jstate, jloss, jg = seg_step(jstate, jnp.asarray(clouds), jnp.asarray(labels),
                                         jax.random.PRNGKey(0))
        jgrads = from_flax_shapenet(_np(jg), _np(jstate.batch_stats))
        want = from_flax_shapenet(_np(jstate.params), _np(jstate.batch_stats))
        _sync(state, before)
        out = train_step(state, torch.from_numpy(clouds), torch.from_numpy(labels))
        assert state.step == int(jstate.step)
        np.testing.assert_allclose(float(out["loss"]), float(jloss), rtol=LOSS_RTOL)
        grads = dict(model.named_parameters())
        top = max(float(g.norm()) for g in jgrads.values())
        for name, p in grads.items():
            want_g = jgrads[name]
            err = float((p.grad - want_g).norm())
            if float(want_g.norm()) >= GRAD_FLOOR * top:
                assert err <= GRAD_RTOL * float(want_g.norm()), (name, err / float(want_g.norm()))
            else:
                assert err <= GRAD_ZERO_TOL * top, (name, err / top)
        got = model.state_dict()
        scale = max(float(want[k].abs().max()) for k in got if "running" in k)
        for name in got:
            if "running" in name:
                assert float((got[name] - want[name]).abs().max()) <= STATS_TOL * scale, name
        lr = state.schedule(state.step - 1)
        for name, p in grads.items():
            off = (p.detach() - want[name]).abs()
            settled = (p.grad - jgrads[name]).abs() <= SETTLED * jgrads[name].abs()
            assert float(torch.where(settled, off, 0.0).max()) <= SETTLED_PARAM_TOL, name
            assert float(off.max()) <= 2.1 * lr, (name, float(off.max()) / lr)


def test_seg_dropout_masks_are_reproducible_per_point():
    """Each head dropout draws a [b, n, 256] mask from the generator: the
    same generator state gives the same output, the kept share of live
    units is 0.8 and a kept unit is scaled by 1/0.8."""
    torch.manual_seed(0)
    model = ShapeNetPVCNN(blocks=((8, 1, None),), with_local_feat=False).train()
    x = torch.cat([torch.randn(8, 256, 6), torch.eye(16)[torch.randint(0, 16, (8,))]
                   [:, None].expand(8, 256, 16)], -1)
    seen = {}
    model.layers["SharedMLP_1"].register_forward_hook(
        lambda m, args, out: seen.__setitem__("pre", out))
    model.layers["SharedMLP_2"].register_forward_hook(
        lambda m, args, out: seen.__setitem__("post", args[0]))
    gen = torch.Generator()
    runs = []
    for _ in range(2):
        gen.manual_seed(7)
        runs.append(model(x, generator=gen).detach())
        runs.append((seen["pre"].detach(), seen["post"].detach()))
    assert torch.equal(runs[0], runs[2]) and torch.equal(runs[1][1], runs[3][1])
    pre, post = runs[1]
    assert pre.shape == (8, 256, 256)
    live, kept = pre > 0, post != 0
    share = float(kept[live].float().mean())
    assert abs(share - 0.8) < 0.01, share
    np.testing.assert_allclose(post[kept].numpy(), (pre[kept] / 0.8).numpy(), rtol=1e-6)
    assert not torch.equal(kept[0], kept[1])  # a mask of its own for every cloud
    with pytest.raises(ValueError, match="Generator"):
        model(x)


@pytest.mark.parametrize("with_normals", [True, False])
def test_train_segmentation_matches_reference_and_resumes(tmp_path, monkeypatch, with_normals):
    """train_segmentation of tiny_smoke without the local branch (as the
    reference's own smoke test runs it) on 8/4 synthetic items of 64
    points, with normals and without (the model's width read from the
    items, as flax reads it), one epoch of 2 steps from the reference's
    init with dropout off, against rift_tpu's: the epoch's loss and the
    test split's mIoU (best and logged); best_iou and common written; a
    resumed finished run trains no further, and one more epoch continues
    from its step."""
    cfg, jcfg = _tiny_configs()
    for c, sub in ((cfg, "port"), (jcfg, "ref")):
        c.train.ckpt_dir = str(tmp_path / sub)
        c.train.steps_per_epoch = 2
        c.optim.num_epochs = 1
        c.model.with_local_feat = None
    items = {"train": 8, "test": 4}
    sn = ShapeNetConfig(num_points=64, synthetic_items=items, with_normals=with_normals)
    sample = next(ShapeNet(sn, "train").batches(cfg.train.batch_size, 0))[0]
    assert sample.shape[-1] == (22 if with_normals else 19)
    jmodel = JaxShapeNetPVCNN(blocks=jcfg.model.blocks, with_local_feat=False,
                              point_kernel_formal=jcfg.model.point_kernel_formal)
    weights = from_flax_shapenet(*_reference_weights(jmodel, sample, seed=jcfg.seed))
    create_state = t_loop.create_state

    def from_reference_init(model, *args, **kwargs):
        model.dropout = 0.0
        state = create_state(model, *args, **kwargs)
        state.model.load_state_dict(weights)
        return state

    monkeypatch.setattr(t_loop, "create_state", from_reference_init)
    got = train_segmentation(cfg, sn, resume=False, device="cpu")
    with fnn.intercept_methods(_no_dropout):
        want = jax_train_segmentation(jcfg, JaxShapeNetConfig(
            num_points=64, synthetic_items=items, with_normals=with_normals), resume=False)
    logs = {}
    for c in (cfg, jcfg):
        with open(os.path.join(c.train.ckpt_dir, f"{c.name}.metrics.jsonl")) as f:
            logs[c.train.ckpt_dir] = [json.loads(line) for line in f]
    g, w = logs[cfg.train.ckpt_dir], logs[jcfg.train.ckpt_dir]
    assert [r["step"] for r in g] == [r["step"] for r in w] == [2]
    assert abs(g[0]["loss"] - w[0]["loss"]) <= LOSS_RTOL * w[0]["loss"], (g, w)
    assert got["best"]["iou"] == g[0]["iou"]
    assert abs(got["best"]["iou"] - want["best"]["iou"]) <= 1e-3, (got["best"], want["best"])
    assert got["state"].step == 2
    for name in ("best_iou.pt", "common.pt", "common.meta.json"):
        assert os.path.isfile(os.path.join(cfg.train.ckpt_dir, name))
    meta = CheckpointManager(cfg.train.ckpt_dir).load_meta()
    assert meta["best"] == got["best"] and meta["config"]["name"] == "tiny_smoke"

    again = train_segmentation(cfg, sn, device="cpu")
    assert again["state"].step == 2 and again["best"] == got["best"]
    for (k, a), b in zip(got["state"].model.state_dict().items(),
                         again["state"].model.state_dict().values()):
        assert torch.equal(a, b), k
    cfg.optim.num_epochs = 2
    more = train_segmentation(cfg, sn, device="cpu")
    assert more["state"].step == 4
    with open(os.path.join(cfg.train.ckpt_dir, "tiny_smoke.metrics.jsonl")) as f:
        assert [json.loads(line)["epoch"] for line in f] == [0, 1]


def test_build_seg_model_reads_the_reference_fields_alone():
    """The fields train_segmentation ignores change nothing: num_classes,
    with_se, with_coeff, lrf_kind, extra_feature_channels and dtype."""
    cfg, _ = _tiny_configs()
    base = build_seg_model(cfg)
    for field, value in (("num_classes", 7), ("with_se", True), ("with_coeff", True),
                         ("lrf_kind", "pca"), ("extra_feature_channels", 4),
                         ("dtype", "bfloat16")):
        c, _ = _tiny_configs()
        setattr(c.model, field, value)
        other = build_seg_model(c)
        assert {k: v.shape for k, v in other.state_dict().items()} == \
            {k: v.shape for k, v in base.state_dict().items()}, field
    assert base.head["Dense_0"].out_features == 50
    assert not any("coefficient" in k or ".se." in k for k in base.state_dict())
