"""rift_tpu_torch's per-stage roofline accounting against rift_tpu's
(`train/roofline.py`): the same StageCost arithmetic and report, the
reference's formulas where they count the function itself, and the
departures (K1's least work for the normals, no one-hot gather and no
materialized activations in the local branch, bytes at the dtype's size)
at or below the reference's counts and equal to counts worked by hand;
the peaks table of the card."""
import numpy as np
import pytest
import torch

from rift_tpu.train import roofline as ref
from rift_tpu_torch.data import SyntheticPairs
from rift_tpu_torch.ops.cuda import normals_kernel as nk
from rift_tpu_torch.train import roofline

H100 = roofline.ChipPeaks("h100_sxm", 989e12, 67e12, 3.35e12)
SHAPES = [(2, 64, 16), (8, 256, 32), (128, 1024, 128)]  # (clouds b, points n, local k)


def _ref_peaks(p):
    return ref.ChipPeaks(p.name, p.flops_bf16, p.flops_f32, p.hbm_gbps)


def _fields(cost):
    return cost.name, cost.flops, cost.bytes, cost.dtype


def test_public_names_are_the_reference_ones():
    names = {"ChipPeaks", "chip_peaks", "StageCost", "F32", "cost_normals", "cost_local_ppf",
             "cost_pvconv", "cost_matching", "cost_gnc", "flagship_costs"}
    assert names <= set(vars(ref)) and names <= set(vars(roofline))
    assert roofline.F32 == ref.F32 == 4


@pytest.mark.parametrize("peaks", [H100, roofline.PLACEHOLDER])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_stage_cost_t_min_and_report_match_reference(rng, peaks, dtype):
    for _ in range(20):
        flops, nbytes = 10.0 ** rng.uniform(6, 13), 10.0 ** rng.uniform(5, 11)
        measured_s = 10.0 ** rng.uniform(-6, -1)
        ours = roofline.StageCost("stage", flops, nbytes, dtype)
        theirs = ref.StageCost("stage", flops, nbytes, dtype)
        assert ours.t_min(peaks) == theirs.t_min(_ref_peaks(peaks))
        assert ours.report(measured_s, peaks) == theirs.report(measured_s, _ref_peaks(peaks))
    report = roofline.StageCost("s", 1.0, 1.0).report(1.0, peaks)
    assert list(report) == ["stage", "measured_ms", "flops_g", "hbm_gb", "bound", "t_min_ms",
                            "sol_fraction", "mfu"]


@pytest.mark.parametrize("b,n,k", SHAPES)
def test_kept_formulas_equal_the_reference(b, n, k):
    pairs = b // 2
    for cin, cout in ((71, 64), (64, 128), (3, 5)):
        for r in (8, 32):
            for bf16 in (False, True):
                ours = roofline.cost_pvconv(b, n, r, cin, cout, bf16=bf16)
                theirs = ref.cost_pvconv(b, n, r, cin, cout, bf16=bf16)
                assert (ours.name, ours.flops, ours.dtype) == (theirs.name, theirs.flops,
                                                               theirs.dtype)
                if not bf16:
                    assert ours.bytes == theirs.bytes
    for c in (32, 512):
        assert _fields(roofline.cost_matching(pairs, n, c)) == _fields(
            ref.cost_matching(pairs, n, c))
    for iters in (1, 45, 100):
        assert _fields(roofline.cost_gnc(pairs, n, iters)) == _fields(
            ref.cost_gnc(pairs, n, iters))
    assert _fields(roofline.cost_gnc(pairs, n)) == _fields(ref.cost_gnc(pairs, n))


@pytest.mark.parametrize("b,n,k", SHAPES)
def test_replaced_formulas_are_at_or_below_the_reference(b, n, k):
    ours, theirs = roofline.cost_normals(b, n), ref.cost_normals(b, n)
    assert ours.flops <= theirs.flops and ours.bytes <= theirs.bytes
    for bf16 in (False, True):
        ours = roofline.cost_local_ppf(b, n, k, bf16=bf16)
        theirs = ref.cost_local_ppf(b, n, k, bf16=bf16)
        assert ours.flops <= theirs.flops and ours.bytes <= theirs.bytes
        assert ours.dtype == theirs.dtype
        ours = roofline.cost_pvconv(b, n, 32, 71, 64, bf16=bf16)
        theirs = ref.cost_pvconv(b, n, 32, 71, 64, bf16=bf16)
        assert ours.bytes == (theirs.bytes / 2 if bf16 else theirs.bytes)
    for peaks in (H100, roofline.PLACEHOLDER):
        for name in ("normals", "local_ppf"):
            ours = getattr(roofline, f"cost_{name}")(b, n, *([k] if name == "local_ppf" else []))
            theirs = getattr(ref, f"cost_{name}")(b, n, *([k] if name == "local_ppf" else []))
            assert ours.t_min(peaks) <= theirs.t_min(_ref_peaks(peaks))


def test_replaced_formulas_equal_hand_counts():
    # normals, 2 clouds of 8 points, k = 4: 2·8·8 pairs x 11 operations +
    # 2·8·4 neighbours x 22; 2·8 points x (3 + 13) f32 values.
    normals = roofline.cost_normals(2, 8, 4)
    assert (normals.flops, normals.bytes, normals.dtype) == (1408 + 1408, 1024, "f32")
    assert roofline.cost_normals(2, 8, 4, neighbours=20).flops == 1408 + 440
    assert roofline.cost_normals(1, 3, 16).flops == 9 * 11 + 22 * 9  # k past n: n a query
    # local PPF, 2 clouds of 8 points, k = 4, SharedMLP(4 -> 2 -> 3): the
    # distances 2·2·8·8·3, the MLP 2·2·8·4·(4·2 + 2·3); points and normals
    # read in f32 (2·8·6·4 bytes), the fused [2, 8, 3] written.
    local = roofline.cost_local_ppf(2, 8, 4, fuse=(2, 3), bf16=True)
    assert (local.flops, local.bytes, local.dtype) == (768 + 1792, 384 + 96, "bf16")
    assert roofline.cost_local_ppf(2, 8, 4, fuse=(2, 3)).bytes == 384 + 192
    # PVConv in bf16, 1 cloud of 2 points, r = 2, 1 -> 1 channel: the
    # reference's terms (convolutions 2·8·27·2, point branch 2·2·2) with
    # 2-byte elements: 2·(2 + 8·3 + 2·9 + 2·3).
    pv = roofline.cost_pvconv(1, 2, 2, 1, 1, bf16=True)
    assert (pv.flops, pv.bytes, pv.dtype) == (864 + 8, 100, "bf16")


def test_flagship_costs_at_h100_peaks():
    """The bounds at the reference's report shapes on H100 SXM peaks."""
    ours, theirs = roofline.flagship_costs(), ref.flagship_costs()
    assert list(ours) == list(theirs)
    assert [c.name for c in ours.values()] == [c.name for c in theirs.values()]
    t_min = {name: cost.t_min(H100) * 1e3 for name, cost in ours.items()}
    np.testing.assert_allclose([t_min[s] for s in ("pvconv1", "pvconv2", "matching", "gnc")],
                               [1.98, 5.63, 1.03, 0.042], rtol=0.01)
    assert 0.022 < t_min["normals"] < 0.023
    assert ours["pvconv1"].flops / 989e12 > ours["pvconv1"].bytes / 3.35e12
    assert ours["gnc"].bytes / 3.35e12 > ours["gnc"].flops / 67e12
    for name in ("normals", "local_ppf"):
        assert ours[name].t_min(H100) < theirs[name].t_min(_ref_peaks(H100))


def test_cost_normals_floor_is_within_a_tenth_of_the_run_count():
    """On clouds of the main path (SyntheticPairs, 1024 points) the floor
    of k = 16 neighbours a query gives a bound within 10% of, and not above,
    the one from K1's own neighbour count (chip_smoke.py's K1 bound)."""
    src, dst, _ = SyntheticPairs(num_pairs=2, num_points=1024, mode="noise", seed=0).arrays()
    clouds = torch.as_tensor(np.concatenate([src, dst], 0))
    cnt = nk.neighborhood_moments(clouds, 16, 0.1 * 0.1)[2]
    assert bool((cnt >= 16).all())
    b, n = clouds.shape[:2]
    run = roofline.cost_normals(b, n, neighbours=float(cnt.sum())).t_min(H100)
    floor = roofline.cost_normals(b, n).t_min(H100)
    assert 0.9 * run <= floor <= run


@pytest.mark.parametrize("name,peaks", [
    ("NVIDIA H100 80GB HBM3", (989e12, 67e12, 3.35e12)),
    ("NVIDIA H100 PCIe", (756e12, 51e12, 2.0e12)),
    ("NVIDIA H100 NVL", (835e12, 60e12, 3.9e12))])
def test_chip_peaks_of_the_h100_parts(monkeypatch, name, peaks):
    got = roofline.peaks_for_name(name)
    assert (got.flops_bf16, got.flops_f32, got.hbm_gbps) == peaks
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    assert roofline.chip_peaks() == got == roofline.chip_peaks("cuda")


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB", "NVIDIA H200", "Tesla V100"])
def test_chip_peaks_raise_on_an_unknown_card(monkeypatch, name):
    with pytest.raises(ValueError, match="no published peaks"):
        roofline.peaks_for_name(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    with pytest.raises(ValueError, match="no published peaks"):
        roofline.chip_peaks()


def test_chip_peaks_on_the_cpu_are_the_reference_placeholder(monkeypatch):
    peaks = roofline.chip_peaks("cpu")
    assert peaks is roofline.PLACEHOLDER and "placeholder" in peaks.name
    placeholder = ref.chip_peaks()  # JAX on the CPU: the reference's unknown-chip peaks
    assert (peaks.flops_bf16, peaks.flops_f32, peaks.hbm_gbps) == (
        placeholder.flops_bf16, placeholder.flops_f32, placeholder.hbm_gbps)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        roofline.chip_peaks()
