"""rift_tpu_torch's auxiliaries against rift_tpu's on the same numpy inputs:
the RPM-Net h5 pairs (`ModelNetHdf` in its three modes, on the synthetic
stand-in and on h5 files the test writes; `half_space_crop`, `resample`),
the losses with their gradients, `rpmnet_metrics`, `MeterRPMNet` and
`MeterReflection`, the 4-class reflection set, and `se3`'s random draws
from given uniforms or normals."""
import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.data.mn40_hdf import Mn40HdfConfig as JMn40HdfConfig
from rift_tpu.data.mn40_hdf import ModelNetHdf as JModelNetHdf
from rift_tpu.data.modelnet40 import ModelNet40Config as JModelNet40Config
from rift_tpu.data.modelnet40_4class import ModelNet40FourClass as JFourClass
from rift_tpu.data.modelnet40_4class import reflection_label as j_reflection_label
from rift_tpu.data.transforms import half_space_crop as j_half_space_crop
from rift_tpu.data.transforms import resample as j_resample
from rift_tpu.ops import losses as j_losses
from rift_tpu.ops import se3 as j_se3
from rift_tpu.registration.metrics import rpmnet_metrics as j_rpmnet_metrics
from rift_tpu.train.meters import MeterReflection as JMeterReflection
from rift_tpu.train.meters import MeterRPMNet as JMeterRPMNet
from rift_tpu_torch.data import (ModelNet40Config, ModelNet40FourClass, Mn40HdfConfig,
                                 ModelNetHdf, reflection_label)
from rift_tpu_torch.data.synthetic_pairs import half_space_crop, resample
from rift_tpu_torch.ops import losses, se3
from rift_tpu_torch.registration import rpmnet_metrics
from rift_tpu_torch.train import MeterReflection, MeterRPMNet

MODES = ("clean", "jitter", "crop")
# f32 functions of the same inputs in another order of operations (XLA's
# fusions against torch's kernels): relative to the largest value.
F32_RTOL = 1e-5


def _close(got, want, rtol=F32_RTOL, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale, msg


def _pairs_equal(port, ref, n=3, seed=0):
    rs_p, rs_r = np.random.RandomState(seed), np.random.RandomState(seed)
    for i in range(n):
        a, b = port.get_pair(i, rs_p), ref.get_pair(i, rs_r)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype


@pytest.mark.parametrize("mode", MODES)
def test_modelnet_hdf_stand_in_pairs_are_the_reference_pairs(mode):
    kw = dict(num_points=128, mode=mode, synthetic_items=3)
    port, ref = ModelNetHdf(Mn40HdfConfig(**kw)), JModelNetHdf(JMn40HdfConfig(**kw))
    assert len(port) == len(ref) == 3
    _pairs_equal(port, ref)
    whole = [list(p.values()) for p in port.pairs(seed=5)]
    want = [list(p.values()) for p in ref.pairs(seed=5)]
    for a, b in zip(whole, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def _write_shards(root, with_normals: bool, m: int = 4, n: int = 96):
    """*train*/*test* shards in the modelnet40_ply_hdf5_2048 layout."""
    rs = np.random.RandomState(11)
    root.mkdir(parents=True, exist_ok=True)
    for split in ("train", "test"):
        for shard in range(2):
            with h5py.File(root / f"ply_data_{split}{shard}.h5", "w") as f:
                f.create_dataset("data", data=rs.randn(m, n, 3).astype(np.float32))
                f.create_dataset("label", data=rs.randint(0, 40, (m, 1)).astype(np.uint8))
                if with_normals:
                    nrm = rs.randn(m, n, 3)
                    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
                    f.create_dataset("normal", data=nrm.astype(np.float32))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("with_normals", [False, True])
def test_modelnet_hdf_files_give_the_reference_pairs(tmp_path, mode, with_normals):
    root = tmp_path / "mn40_hdf"
    _write_shards(root, with_normals)
    for split in ("train", "test"):
        kw = dict(root=str(root), num_points=64, mode=mode)
        port = ModelNetHdf(Mn40HdfConfig(**kw), split)
        ref = JModelNetHdf(JMn40HdfConfig(**kw), split)
        assert len(port) == len(ref) == 8
        np.testing.assert_array_equal(port._clouds, ref._clouds)
        np.testing.assert_array_equal(port._labels, ref._labels)
        _pairs_equal(port, ref, n=8)


def test_modelnet_hdf_rejects_an_empty_root_and_a_bad_mode(tmp_path):
    with pytest.raises(FileNotFoundError):
        ModelNetHdf(Mn40HdfConfig(root=str(tmp_path)))
    with pytest.raises(ValueError):
        ModelNetHdf(Mn40HdfConfig(mode="partial", synthetic_items=1))


def test_half_space_crop_and_resample_are_the_reference(rng):
    pcd = rng.randn(300, 6).astype(np.float32)
    for keep in (0.7, 0.3):
        a = half_space_crop(pcd, keep, np.random.RandomState(4))
        b = j_half_space_crop(pcd, keep, np.random.RandomState(4))
        np.testing.assert_array_equal(a, b)
        assert abs(len(a) - keep * 300) <= 1
    for num in (100, 500):  # without, then with replacement
        np.testing.assert_array_equal(resample(pcd, num, np.random.RandomState(2)),
                                      j_resample(pcd, num, np.random.RandomState(2)))


def _grad_pair(fn_t, fn_j, *arrays):
    """(value, gradients) of the port's and the reference's functions on
    the same float arrays (gradients of every argument)."""
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn_t(*ts)
    out.sum().backward()
    xs = list(map(jnp.asarray, arrays))
    grads = jax.grad(lambda *a: jnp.sum(fn_j(*a)), argnums=tuple(range(len(arrays))))(*xs)
    return out.detach().numpy(), [t.grad.numpy() for t in ts], np.asarray(fn_j(*xs)), \
        [np.asarray(g) for g in grads]


def test_kl_and_huber_losses_and_their_gradients(rng):
    x = rng.randn(6, 10).astype(np.float32)
    y = rng.rand(6, 10).astype(np.float32)
    y[y < 0.3] = 0.0  # the y > 0 mask
    y /= y.sum(-1, keepdims=True)
    got, g, want, gw = _grad_pair(losses.kl_loss, j_losses.kl_loss, x, y)
    _close(got, want)
    for a, b in zip(g, gw):
        _close(a, b)
    err = (rng.randn(50) * 2).astype(np.float32)
    for delta in (1.0, 0.5, 2.0):
        got, g, want, gw = _grad_pair(lambda e: losses.huber_loss(e, delta),
                                      lambda e: j_losses.huber_loss(e, delta), err)
        _close(got, want)
        _close(g[0], gw[0])


def test_chamfer_distance_and_its_gradients(rng):
    a = rng.randn(3, 40, 3).astype(np.float32)
    b = (rng.randn(3, 56, 3) * 1.2).astype(np.float32)
    got, g, want, gw = _grad_pair(losses.chamfer_distance, j_losses.chamfer_distance, a, b)
    assert got.shape == (3,)
    _close(got, want)
    for x, y in zip(g, gw):
        _close(x, y)


def _transforms(rng, b):
    t = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    for i in range(b):
        q, _ = np.linalg.qr(rng.randn(3, 3))
        t[i, :3, :3] = q * np.sign(np.linalg.det(q))
        t[i, :3, 3] = rng.uniform(-0.5, 0.5, 3)
    return t


def test_rpmnet_metrics_and_meter_are_the_reference(rng):
    b = 5
    src = rng.randn(b, 64, 3).astype(np.float32)
    ref = rng.randn(b, 80, 3).astype(np.float32)
    gt, est = _transforms(rng, b), _transforms(rng, b)
    est[0] = gt[0]  # a perfect pair: RRE 0
    got = rpmnet_metrics(*map(torch.from_numpy, (src, ref, gt, est)))
    want = j_rpmnet_metrics(*map(jnp.asarray, (src, ref, gt, est)))
    assert list(got) == list(want)
    for k in got:
        assert got[k].shape == (b,)
        _close(got[k].numpy(), want[k], msg=k)
    meter, jmeter = MeterRPMNet(), JMeterRPMNet()
    for sl in (slice(0, 2), slice(2, 5)):
        meter.update({k: v[sl] for k, v in got.items()})
        jmeter.update({k: np.asarray(v)[sl] for k, v in want.items()})
    out, jout = meter.compute(), jmeter.compute()
    assert list(out) == list(jout) == list(MeterRPMNet.KEYS)
    for k in out:
        assert out[k] == pytest.approx(jout[k], rel=F32_RTOL), k


def test_meters_compute_the_reference_on_given_numbers():
    metrics = {k: np.asarray([0.5 + i, 2.0 + i], np.float32) for i, k in
               enumerate(MeterRPMNet.KEYS)}
    meter, jmeter = MeterRPMNet(), JMeterRPMNet()
    meter.update(metrics)
    jmeter.update(metrics)
    meter.update({k: torch.tensor(3.0) for k in MeterRPMNet.KEYS})  # one pair, a tensor
    jmeter.update({k: np.float32(3.0) for k in MeterRPMNet.KEYS})
    assert meter.compute() == jmeter.compute()
    logits = np.asarray([[0.1, 0.9, 0, 0], [2, 0, 0, 1], [0, 0, 0, 5]], np.float32)
    for labels in (np.asarray([1, 0, 2]), np.asarray([[7, 1], [3, 0], [9, 2]])):
        r, jr = MeterReflection(), JMeterReflection()
        r.update(logits, labels)
        jr.update(logits, labels)
        assert r.compute() == jr.compute() == {"reflect_acc": 2 / 3}
    assert MeterReflection().compute() == {"reflect_acc": 0.0}


def test_reflection_label_is_the_reference(rng):
    src = rng.randn(200, 3) * np.array([3.0, 2.0, 1.0])
    seen = set()
    for i in range(24):
        t = _transforms(rng, 1)[0].astype(np.float64)
        if i % 3 == 0:  # a reflection in the estimate flips the bits
            t[:3, 0] *= -1
        dst = src @ t[:3, :3].T + t[:3, 3]
        label = reflection_label(src, dst, t[:3, :3])
        assert label == j_reflection_label(src, dst, t[:3, :3])
        seen.add(label)
    assert reflection_label(src, src.copy(), np.eye(3)) == 0
    assert len(seen) > 1


@pytest.mark.parametrize("with_normals", [True, False])
def test_four_class_items_are_the_reference_items(with_normals):
    items = {"train": 3, "valid": 3, "test": 3}
    port = ModelNet40FourClass(ModelNet40Config(num_points=128, synthetic_items=items,
                                                with_normals=with_normals), "test")
    ref = JFourClass(JModelNet40Config(num_points=128, synthetic_items=items,
                                       with_normals=with_normals), "test")
    assert all(not v for v in port.config.random_rot.values())
    rs_p, rs_r = np.random.RandomState(3), np.random.RandomState(3)
    for i in range(3):
        (cloud, labels), (jcloud, jlabels) = port.get(i, rs_p), ref.get(i, rs_r)
        np.testing.assert_array_equal(cloud, jcloud)
        assert cloud.dtype == jcloud.dtype and cloud.shape == (128, 6 if with_normals else 3)
        assert labels == jlabels
    # By seed, as batches call it: the base class's RandomState of (seed, i).
    clouds, labels = next(port.batches(3, seed=2, shuffle=False))
    assert clouds.shape[0] == 3 and labels.shape == (3, 2)
    np.testing.assert_array_equal(clouds[1], port.get(1, seed=2 * 131 + 1)[0])


def test_random_rotation_from_the_reference_uniforms():
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        k1, k2, k3 = jax.random.split(key, 3)
        x = np.array(jax.random.uniform(k1, (6,)))
        u_deg, u_amp = (np.array(jax.random.uniform(k, ())) for k in (k2, k3))
        for max_degree, max_amp in ((360.0, 3.0), (45.0, 0.5)):
            want = np.asarray(j_se3.random_rotation(key, max_degree, max_amp))
            got = se3.random_rotation_from_uniforms(
                *map(torch.from_numpy, (x, u_deg, u_amp)), max_degree, max_amp).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_random_so3_and_sphere_from_the_reference_draws():
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        q = np.array(jax.random.normal(key, (4,)))
        np.testing.assert_allclose(se3.random_so3_from_normals(torch.from_numpy(q)).numpy(),
                                   np.asarray(j_se3.random_so3(key)), rtol=0, atol=1e-6)
        k1, k2 = jax.random.split(key)
        u_phi, u_cos = (torch.from_numpy(np.array(jax.random.uniform(k, ()))) for k in (k1, k2))
        np.testing.assert_allclose(se3.uniform_2_sphere_from_uniforms(u_phi, u_cos).numpy(),
                                   np.asarray(j_se3.uniform_2_sphere(key)), rtol=0, atol=1e-6)


def test_draws_from_a_generator_are_rotations_and_unit_vectors():
    gen = torch.Generator().manual_seed(0)
    eye = torch.eye(3)
    for _ in range(8):
        t = se3.random_rotation(gen, 90.0, 2.0)
        rot = t[:3, :3]
        assert t.shape == (4, 4) and torch.equal(t[3], torch.tensor([0.0, 0, 0, 1]))
        torch.testing.assert_close(rot @ rot.T, eye, rtol=0, atol=1e-6)
        assert abs(float(torch.linalg.det(rot)) - 1.0) < 1e-5
        assert float(torch.linalg.vector_norm(t[:3, 3])) <= 2.0 + 1e-6
        angle = torch.arccos(torch.clamp((torch.trace(rot) - 1) / 2, -1, 1)) * 180 / np.pi
        assert float(angle) <= 90.0 + 1e-3
        r = se3.random_so3(gen)
        torch.testing.assert_close(r @ r.T, eye, rtol=0, atol=1e-6)
        assert abs(float(torch.linalg.det(r)) - 1.0) < 1e-5
        v = se3.uniform_2_sphere(gen)
        assert v.shape == (3,) and abs(float(torch.linalg.vector_norm(v)) - 1.0) < 1e-6
    again = torch.Generator().manual_seed(0)
    torch.testing.assert_close(se3.random_rotation(again, 90.0, 2.0),
                               se3.random_rotation(torch.Generator().manual_seed(0), 90.0, 2.0),
                               rtol=0, atol=0)
