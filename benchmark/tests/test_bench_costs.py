"""The frozen counts against the port's `train/roofline.py` where both count
today (64 pairs of 1024 points, the bf16 bench model), and the completed
ones at their shapes."""
from __future__ import annotations

import json
import os

import pytest
from rift_tpu_torch.train.roofline import flagship_costs

from benchmark import costs, harness


def config(name: str) -> dict:
    return json.load(open(os.path.join(harness.BENCH_DIR, "configs", f"{name}.json")))["model"]


def test_stage_counts_equal_the_ports_where_both_count():
    port = flagship_costs(batch_pairs=64, n=1024, k=128, dim_k=512, bf16=True)
    model = config("sph_dg_bf16")
    mine = {s.name: s for s in costs.trunk_costs(model, 128, 1024)}
    assert costs.cost_normals(128, 1024).flops == port["normals"].flops
    assert costs.cost_normals(128, 1024).bytes == port["normals"].bytes
    for ours, theirs in (("local_ppf", "local_ppf"), ("pvconv_r32_71->64", "pvconv1"),
                         ("pvconv_r32_64->128", "pvconv2")):
        assert mine[ours].flops == port[theirs].flops, ours
        assert mine[ours].bytes == port[theirs].bytes, ours
    match = costs.cost_matching(64, 1024, 512)
    assert (match.flops, match.bytes) == (port["matching"].flops, port["matching"].bytes)


def test_completed_counts():
    dg, pt = config("sph_dg_bf16"), config("mn40_sph_pt_f32")
    trunk = {s.name: s.flops for s in costs.trunk_costs(dg, 2, 1024)}
    assert trunk["mlp_128->256"] == 2 * 2 * 1024 * 128 * 256
    assert trunk["mlp_256->512"] == 2 * 2 * 1024 * 256 * 512
    # pointnet's point branch reads c_in channels, dgcnn's 2·c_in.
    a = costs.cost_pvconv(1, 1024, 32, 67, 64, dgcnn=False).flops
    b = costs.cost_pvconv(1, 1024, 32, 67, 64, dgcnn=True).flops
    assert b - a == 2 * 1024 * 67 * 64
    plain = costs.register_flops(pt, 64, 1024, flips=False)
    flips = costs.register_flops(pt, 64, 1024, flips=True)
    extra = (sum(s.flops for s in costs.trunk_costs(pt, 192, 1024))
             + 3 * costs.cost_matching(64, 1024, 512).flops)
    assert flips - plain == pytest.approx(extra)
    fwd = sum(s.flops for s in costs.trunk_costs(pt, 16, 1024)) + costs.cost_head(16, 512,
                                                                                  40).flops
    assert costs.train_flops(pt, 16, 1024) == pytest.approx(3 * fwd)


def test_k5_bound_is_chip_smokes_arithmetic():
    peaks = costs.peaks_for_name("NVIDIA H100 80GB HBM3")
    launches = costs.k5_launches(config("sph_dg_bf16"), 256)
    assert len(launches) == 4
    flops, nbytes = launches[0]
    assert flops == 2 * 27 * 32 ** 3 * 71 * 64 * 256
    assert nbytes == 256 * 32 ** 3 * (71 + 64) * 2 + 27 * 71 * 64 * 2
    assert costs.k5_bound_s(config("sph_dg_bf16"), 256, peaks) == pytest.approx(
        sum(f for f, _ in launches) / 989e12)
    with pytest.raises(ValueError):
        costs.peaks_for_name("cpu")
