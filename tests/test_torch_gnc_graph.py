"""GNC-TLS's fixed schedule replayed as a captured CUDA graph
(`rift_tpu_torch/registration/gnc.py:_FixedGraph`), on a CUDA card: the
replay equals the eager loop bit for bit on two batches of one shape and on
a second shape, `register_batch(early_exit=False)` makes no host sync, and
a `gnc_pose` captured inside a caller's own graph stays eager. Every test
is marked `card` and skips without one; on a card:

    python -m pytest --noconftest -m card tests/test_torch_gnc_graph.py

(this file imports no JAX, and `--noconftest` leaves out the suite's JAX
set-up)."""
import numpy as np
import pytest
import torch

from rift_tpu_torch.models import bench_model
from rift_tpu_torch.ops.precision import f32_geometry
from rift_tpu_torch.registration import gnc, gnc_pose, register_batch
from rift_tpu_torch.registration.pipeline import NOISE_BOUND

pytestmark = pytest.mark.card

C2 = NOISE_BOUND * NOISE_BOUND


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _matches(seed: int, b: int, n: int, device, outliers: float = 0.5):
    """src/dst [b, n, 3] matches, a share `outliers` of them random, and
    valid [b, n] bool, on `device`."""
    g = torch.Generator().manual_seed(seed)
    src = torch.rand(b, n, 3, generator=g) * 2 - 1
    q = torch.linalg.qr(torch.randn(b, 3, 3, generator=g)).Q
    q = q * torch.linalg.det(q)[:, None, None].sign()
    dst = src @ q.transpose(-1, -2) + torch.rand(b, 1, 3, generator=g) - 0.5
    dst = dst + 0.005 * torch.randn(b, n, 3, generator=g)
    bad = torch.rand(b, n, generator=g) < outliers
    dst[bad] = torch.rand(int(bad.sum()), 3, generator=g) * 3 - 1.5
    valid = torch.rand(b, n, generator=g) > 0.1
    return src.to(device), dst.to(device), valid.to(device)


def test_replay_equals_the_eager_schedule_bit_for_bit(card):
    """Two batches of one shape (the second replays the first's graph on
    new inputs, so stale static inputs would show) and a second shape (a
    second capture)."""
    results = []
    with torch.no_grad(), f32_geometry():
        for seed, (b, n) in enumerate([(16, 384), (16, 384), (8, 640)]):
            src, dst, valid = _matches(seed, b, n, card)
            t, w = gnc_pose(src, dst, valid, noise_bound=NOISE_BOUND, early_exit=False)
            key = gnc._graph_key(src, dst, valid.to(src.dtype), NOISE_BOUND, 1.4, 100)
            want_t, want_w = gnc._tls_fixed(src, dst, valid.to(src.dtype), C2, 1.4, 100)
            torch.cuda.synchronize()
            assert torch.equal(t, want_t) and torch.equal(w, want_w), (b, n)
            results.append((key, gnc._GRAPHS.entries[key], t))
    (k0, g0, t0), (k1, g1, t1), (k2, g2, _) = results
    assert k0 == k1 and g0 is g1  # one capture, replayed on the second batch
    assert not torch.equal(t0, t1)  # the batches differ, so their poses do
    assert k2 != k0 and g2 is not g0


def test_register_batch_fixed_schedule_makes_no_host_sync(card):
    """The first call (features, matching, the capture) and a replay under
    CUDA's sync debug mode "error"."""
    model = bench_model("dgcnn").eval().to(card)
    src, dst, _ = _matches(7, 4, 1024, card, outliers=0.0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = register_batch(model, src, dst, device=card, early_exit=False)
        again = register_batch(model, src, dst, device=card, early_exit=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(first, again) and bool(torch.isfinite(first).all())


def test_gnc_pose_inside_a_callers_capture_stays_eager(card):
    """A caller that captures gnc_pose in its own graph gets the eager loop:
    no graph of gnc.py's is made for the shape, and the caller's replay
    gives the eager result."""
    src, dst, valid = _matches(11, 4, 448, card)
    v = valid.to(src.dtype)
    key = gnc._graph_key(src, dst, v, NOISE_BOUND, 1.4, 100)
    with torch.no_grad(), f32_geometry():
        want_t, want_w = gnc._tls_fixed(src, dst, v, C2, 1.4, 100)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            t, w = gnc_pose(src, dst, valid, noise_bound=NOISE_BOUND, early_exit=False)
        assert key not in gnc._GRAPHS.entries
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(t, want_t) and torch.equal(w, want_w)
