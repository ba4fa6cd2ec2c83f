"""rift_tpu_torch's part segmentation model against the benchmark's plain
reference (`benchmark/reference/rift_ref/models/shapenet.py`) on the CPU.

The port's model is the one `train/loop.py:build_seg_model` builds, with
narrow blocks and k = 16; one seeded state (`benchmark/weights.py:
seeded_state`) loads into both; the inputs are 4 clouds × 128 points of
the segmentation cell's own clouds (`benchmark/seg_clouds.py`). Compared:
the eval logits, the train-mode logits with one dropout generator (and the
BatchNorm statistics that forward leaves), and one `train_step` against
`benchmark/reference/__init__.py:TrainReference` (the loss, every
gradient, the BatchNorm statistics and the parameters after the update),
for each point kernel with and without the local branch.

Every comparison is exact. On the CPU the port runs its kernels' plain
versions, and the reference is a copy of the same plain functions, so the
two compute the same operations in the same order; a difference is a
departure of one from the other, not rounding.
"""
from types import SimpleNamespace

import pytest
import torch

from benchmark import reference, seg_clouds, weights
from benchmark.reference.rift_ref.models.shapenet import ShapeNetPVCNN as RefShapeNetPVCNN
from rift_tpu_torch.train import build_seg_model
from rift_tpu_torch.train.steps import TrainState, make_optimizer, train_step

BLOCKS = ((16, 1, 8), (32, 1, 8), (32, 1, None), (64, 1, None))
NEIGHBORS = 16
OPTIM = {"lr": 1e-3, "weight_decay": 1e-6, "num_epochs": 90, "schedule": "cosine",
         "grad_clip": None}
STEPS_PER_EPOCH = 1517
SEED = 2 ** 40 + 21
KERNELS = ("dgcnn_kernel", "pointnet_kernel")
LOCAL = {"local": True, "no_local": False}


@pytest.fixture(scope="module")
def batch():
    clouds, labels = seg_clouds.seg_clouds(SEED, 4, 128)
    return torch.from_numpy(clouds), torch.from_numpy(labels)


def _models(kernel: str, local: bool):
    """(port, reference, state): both models holding one seeded state."""
    model = SimpleNamespace(blocks=BLOCKS, point_kernel_formal=kernel, voxel_shape="spherical",
                            rot_invariant_preprocess="change_coords", with_local_feat=local,
                            local_neighbors=NEIGHBORS, width_multiplier=1.0)
    port = build_seg_model(SimpleNamespace(model=model))
    ref = RefShapeNetPVCNN(blocks=BLOCKS, point_kernel_formal=kernel, with_local_feat=local,
                           local_neighbors=NEIGHBORS)
    state = weights.seeded_state(port, SEED, torch.device("cpu"))
    port.load_state_dict(state)
    ref.load_state_dict(state)
    return port, ref, state


def _bn_stats(model) -> dict:
    return {k: v for k, v in model.state_dict().items()
            if k.endswith("running_mean") or k.endswith("running_var")}


def _assert_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("kernel", KERNELS)
def test_state_dict_names_and_shapes_are_the_ports(kernel):
    port, ref, _ = _models(kernel, True)
    assert {k: v.shape for k, v in port.state_dict().items()} == {
        k: v.shape for k, v in ref.state_dict().items()}


@pytest.mark.parametrize("local", LOCAL.values(), ids=LOCAL)
@pytest.mark.parametrize("kernel", KERNELS)
def test_eval_logits_equal_the_references(batch, kernel, local):
    port, ref, _ = _models(kernel, local)
    with torch.no_grad():
        got, want = port.eval()(batch[0]), ref.eval()(batch[0])
    assert got.shape == (4, 128, seg_clouds.NUM_PARTS)
    assert torch.equal(got, want)


@pytest.mark.parametrize("local", LOCAL.values(), ids=LOCAL)
@pytest.mark.parametrize("kernel", KERNELS)
def test_train_logits_equal_the_references_with_one_generator(batch, kernel, local):
    port, ref, _ = _models(kernel, local)
    with torch.no_grad():
        got = port.train()(batch[0], generator=torch.Generator().manual_seed(5))
        want = ref.train()(batch[0], generator=torch.Generator().manual_seed(5))
        _assert_equal(_bn_stats(port), _bn_stats(ref))
        other = port(batch[0], generator=torch.Generator().manual_seed(6))
    assert torch.equal(got, want)
    assert not torch.equal(got, other)  # the masks come from the generator


@pytest.mark.parametrize("local", LOCAL.values(), ids=LOCAL)
@pytest.mark.parametrize("kernel", KERNELS)
def test_train_step_equals_the_reference_step(batch, kernel, local):
    port, ref, state = _models(kernel, local)
    optimizer, schedule = make_optimizer(
        port, SimpleNamespace(optim=SimpleNamespace(**OPTIM)), STEPS_PER_EPOCH)
    out = train_step(TrainState(port, optimizer, schedule, OPTIM["grad_clip"]), *batch,
                     torch.Generator().manual_seed(7))
    ref_step = reference.TrainReference(ref, OPTIM, STEPS_PER_EPOCH)
    ref_loss = ref_step.step(*batch, torch.Generator().manual_seed(7))
    assert torch.equal(out["loss"], ref_loss)
    _assert_equal({k: p.grad for k, p in port.named_parameters()},
                  {k: p.grad for k, p in ref.named_parameters()})
    _assert_equal(_bn_stats(port), _bn_stats(ref))
    _assert_equal(dict(port.state_dict()), dict(ref.state_dict()))
    assert not torch.equal(port.state_dict()["head.Dense_0.weight"],
                           state["head.Dense_0.weight"])  # the step moved the weights
