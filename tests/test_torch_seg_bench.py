"""The segmentation cell's pieces on the CPU: its inputs
(`benchmark/seg_clouds.py`), its operation count (`benchmark/costs_seg.py`)
against a hand count at the published widths, and the training step's
spans (`train/steps.py`, `models/shapenet.py`): recorded inside a profiler
window with `train.forward` as the parent of the model's spans, absent
outside one, and the arithmetic bit-equal either way."""
import copy
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import costs_seg, pairs, seg_clouds
from rift_tpu_torch import tracing
from rift_tpu_torch.models import PVCNNClassifier, ShapeNetPVCNN
from rift_tpu_torch.train.steps import TrainState, make_optimizer, train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 40 + 33
OPTIM = SimpleNamespace(optim=SimpleNamespace(lr=1e-3, weight_decay=1e-6, num_epochs=90,
                                              schedule="cosine", grad_clip=None))


def test_categories_hold_shapenets_part_ranges():
    assert seg_clouds.NUM_SHAPES == 16 and seg_clouds.NUM_PARTS == 50
    assert seg_clouds.OFFSETS[-1] + seg_clouds.PARTS[-1] == 50
    for category, parts in enumerate(seg_clouds.PARTS):
        primitives = len(pairs.class_structure(seg_clouds.CLASSES[category]))
        assert primitives <= parts  # a part is a primitive, or a split of one


@pytest.mark.parametrize("category", range(16))
def test_every_part_is_reached_at_2048_points(category):
    cloud = pairs.make_cloud(seg_clouds.CLASSES[category], 2048, seed=category + 100)
    labels = seg_clouds.part_labels(cloud, category)
    offset, parts = seg_clouds.OFFSETS[category], seg_clouds.PARTS[category]
    counts = np.bincount(labels - offset, minlength=parts)
    assert counts.shape == (parts,) and counts.min() >= 2048 // 8


def test_seg_clouds_layout_and_labels():
    clouds, labels = seg_clouds.seg_clouds(SEED, 24, 2048)
    assert clouds.shape == (24, 2048, 22) and clouds.dtype == np.float32
    assert labels.shape == (24, 2048) and labels.dtype == np.int64
    one_hot = clouds[..., 6:]
    assert np.array_equal(one_hot.sum(-1), np.ones((24, 2048), np.float32))
    assert (one_hot == one_hot[:, :1]).all()  # one category a cloud
    category = one_hot[:, 0].argmax(-1)
    lo = np.asarray(seg_clouds.OFFSETS)[category][:, None]
    hi = lo + np.asarray(seg_clouds.PARTS)[category][:, None]
    assert ((labels >= lo) & (labels < hi)).all()
    # make_cloud scales into the unit ball; the rotation keeps norms (f32
    # rounding of the rotated coordinates, a few ulps of 1).
    assert np.linalg.norm(clouds[..., :3], axis=-1).max() <= 1.0 + 1e-6
    np.testing.assert_allclose(np.linalg.norm(clouds[..., 3:6], axis=-1), 1.0, atol=1e-5)


def test_seg_clouds_follow_the_seed():
    a = seg_clouds.seg_clouds(SEED, 4, 256)
    b = seg_clouds.seg_clouds(SEED, 4, 256)
    c = seg_clouds.seg_clouds(SEED + 1, 4, 256)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])


def test_seg_count_at_the_published_widths_is_the_hand_count():
    model = json.load(open(os.path.join(ROOT, "benchmark", "configs",
                                        "shapenet_seg.json")))["model"]
    b, n = 8, 2048
    stages = {s.name: s.flops for s in costs_seg.seg_costs(model, b, n)}
    hand = {
        "local_ppf": 2 * b * n * n * 3 + 2 * b * n * 128 * (4 * 32 + 32 * 64),
        "pvconv_r32_71->64": 2 * b * 32 ** 3 * 27 * (71 * 64 + 64 * 64) + 2 * b * n * 142 * 64,
        "pvconv_r32_64->128": (2 * b * 32 ** 3 * 27 * (64 * 128 + 128 * 128)
                               + 2 * b * n * 128 * 128),
        "mlp_128->256": 2 * b * n * 128 * 256,
        "mlp_256->512": 2 * b * n * 256 * 512,
        # the head's input: one-hot 16 + 64 + 128 + 256 + 512 + the global max 512
        "mlp_1488->256": 2 * b * n * 1488 * 256,
        "mlp_256->256": 2 * b * n * 256 * 256,
        "mlp_256->128": 2 * b * n * 256 * 128,
        "mlp_128->50": 2 * b * n * 128 * 50,
    }
    assert stages == hand
    assert costs_seg.forward_flops(model, b, n) == sum(hand.values())
    assert costs_seg.forward_flops(model, b, n) == pytest.approx(5.02e11, rel=1e-3)
    assert costs_seg.train_flops(model, b, n) == 3 * sum(hand.values())


def _seg_batch():
    clouds, labels = seg_clouds.seg_clouds(SEED, 2, 64)
    model = ShapeNetPVCNN(blocks=((8, 1, 4), (16, 1, None)), with_local_feat=True,
                          local_neighbors=8)
    return model, torch.from_numpy(clouds), torch.from_numpy(labels)


def _cls_batch():
    clouds, labels = pairs.class_clouds(SEED, 2, 64)
    model = PVCNNClassifier(blocks=((8, 1, 4), (16, 1, None)), local_neighbors=8,
                            point_kernel_formal="pointnet_kernel", lrf_kind="pca")
    return model, torch.from_numpy(clouds), torch.from_numpy(labels)


MODELS = {"segmentation": _seg_batch, "classifier": _cls_batch}
WITHIN = {"segmentation": {"pvcnn.local", "seg.head"}, "classifier": {"pvcnn.local"}}
TOP = {"train.forward", "train.backward", "train.update"}


def _step(model, clouds, labels, traced: bool):
    """One train_step on a copy of `model`: its loss, state and snapshot."""
    model = copy.deepcopy(model)
    optimizer, schedule = make_optimizer(model, OPTIM, 100)
    state = TrainState(model, optimizer, schedule)
    tracing.reset()
    gen = torch.Generator().manual_seed(3)
    if traced:
        with profile(activities=[ProfilerActivity.CPU]):
            loss = train_step(state, clouds, labels, gen)["loss"]
    else:
        loss = train_step(state, clouds, labels, gen)["loss"]
    snap = tracing.snapshot()
    tracing.reset()
    return loss, model.state_dict(), snap


@pytest.mark.parametrize("kind", MODELS)
def test_train_step_records_its_spans_in_a_window_alone(kind):
    model, clouds, labels = MODELS[kind]()
    loss_off, state_off, snap_off = _step(model, clouds, labels, traced=False)
    loss_on, state_on, snap_on = _step(model, clouds, labels, traced=True)
    assert snap_off["spans"] == {} and snap_off["counters"] == {}
    spans = snap_on["spans"]
    assert set(spans) == TOP | WITHIN[kind]
    assert all(spans[name]["parent"] is None for name in TOP)
    assert all(spans[name]["parent"] == "train.forward" for name in WITHIN[kind])
    assert all(s["count"] == 1 and s["device_s"] is None for s in spans.values())
    inner = sum(spans[name]["host_s"] for name in WITHIN[kind])
    forward = spans["train.forward"]
    assert forward["host_self_s"] == pytest.approx(forward["host_s"] - inner)
    # The spans leave the arithmetic as it is: the loss and every parameter
    # and statistic bit-equal with and without the window.
    assert torch.equal(loss_on, loss_off)
    assert state_on.keys() == state_off.keys()
    assert all(torch.equal(state_on[k], state_off[k]) for k in state_off)
