"""The controls on a card: the reference in the program's place, one step
below the configuration's precision (TF32 for the f32 configuration with
TF32 off), comes out not correct at a small size. The fp8 control of the
bf16 configuration runs on the CPU too (`test_bench_drivers.py`). The
cells' own sizes are read by `benchmark/control.py` on the card."""
from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.tests.conftest import tiny


@pytest.mark.card
@pytest.mark.parametrize("cell", ["mn40_sph_pt_f32.train_b16", "mn40_sph_pt_f32.eval_teaser_b64",
                                  "sph_dg_bf16.noise_b128"])
def test_control_is_not_correct_on_the_card(card, cell):
    spec = tiny(cell)
    # K5 takes r in 16, 32, 64, 128.
    spec.config["model"]["blocks"] = [[16, 1, 16], [32, 1, 16], [32, 1, None], [64, 1, None]]
    built = harness.load_piece("drivers", spec.traffic["driver"]).build(
        harness.Context(spec, 2 ** 40 + 9, card, program="control"))
    first = getattr(built, "calls_in_setup", 0)
    for i in range(first, first + 4):
        built.call(i)
    built.release()
    checks = built.check()
    assert not all(c.ok for c in checks), checks
