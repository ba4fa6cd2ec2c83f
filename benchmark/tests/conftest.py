"""Fixtures of the benchmark's tests: small cells for the CPU, and the
marker of the tests that need a CUDA card (`card`), which skip inside a
fixture where there is none.

    python -m pytest benchmark/tests -q            # the CPU tests
    python -m pytest benchmark/tests -q -m card    # on a card: the controls
"""
from __future__ import annotations

import copy
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark import harness  # noqa: E402

# Narrow blocks and small clouds: the CPU runs the kernels' plain versions.
TINY_BLOCKS = [[16, 1, 8], [32, 1, 8], [32, 1, None], [64, 1, None]]
TINY_TRAFFIC = {"pairs": 2, "batch": 4, "points": 128}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def tiny(name: str) -> harness.CellSpec:
    """The manifest's cell `name` at a size the CPU runs in seconds: narrow
    blocks, 16 local neighbours, 2 pairs or 4 clouds of 128 points."""
    spec = copy.deepcopy(harness.resolve(name))
    spec.config["model"]["blocks"] = copy.deepcopy(TINY_BLOCKS)
    spec.config["model"]["local_neighbors"] = 16
    spec.traffic.update({k: v for k, v in TINY_TRAFFIC.items() if k in spec.traffic})
    return spec


@pytest.fixture
def tiny_spec():
    return tiny


def tiny_dp() -> harness.CellSpec:
    """The four-card data-parallel cell from its files (traffic
    `train_dp4_b16`, its limits), at `tiny`'s size with a global batch of 8:
    the manifest does not run it yet."""
    spec = tiny("mn40_sph_pt_f32.train_b16")
    spec.name, spec.chips = "mn40_sph_pt_f32.train_dp4_b16", 4
    with open(os.path.join(harness.BENCH_DIR, "traffic", "train_dp4_b16.json")) as f:
        spec.traffic = json.load(f)
    spec.traffic.update(batch=8, points=TINY_TRAFFIC["points"])
    with open(os.path.join(harness.BENCH_DIR, "limits", f"{spec.name}.json")) as f:
        spec.limits = json.load(f)
    return spec
