"""GNC-TLS's fixed schedule and TEASER's whole pose replayed as captured
CUDA graphs (`rift_tpu_torch/registration/gnc.py:_Graph`), on a CUDA card:
each replay equals the eager code bit for bit on two batches of one shape
and on a second shape (TEASER's also against the reference's early-exit
polish), neither makes a host sync, a `gnc_pose` or `teaser_pose` captured
inside a caller's own graph stays eager, a TEASER replay counts one replay
and the polish's 100 iterations, and a capture leaves no memory behind
outside its graph's pool. Every test is marked `card` and skips without
one; on a card:

    python -m pytest --noconftest -m card tests/test_torch_gnc_graph.py

(this file imports no JAX, and `--noconftest` leaves out the suite's JAX
set-up)."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rift_tpu_torch import tracing

from rift_tpu_torch.models import bench_model
from rift_tpu_torch.ops.precision import f32_geometry
from rift_tpu_torch.registration import gnc, gnc_pose, register_batch, teaser_pose
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
            key = gnc._graph_key(gnc._tls_fixed, (src, dst, valid.to(src.dtype)), C2, 1.4, 100)
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
    key = gnc._graph_key(gnc._tls_fixed, (src, dst, v), C2, 1.4, 100)
    with torch.no_grad(), f32_geometry():
        want_t, want_w = gnc._tls_fixed(src, dst, v, C2, 1.4, 100)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            t, w = gnc_pose(src, dst, valid, noise_bound=NOISE_BOUND, early_exit=False)
        assert key not in gnc._GRAPHS.entries
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(t, want_t) and torch.equal(w, want_w)


def _teaser_key(src, dst, valid):
    with f32_geometry():
        return gnc._graph_key(gnc._teaser_fixed, (src, dst, valid), NOISE_BOUND, 4)


def _early_exit_teaser(src, dst, valid):
    """TEASER as the reference runs it: the polish is `gnc_pose`'s early
    exit from `_tim_pose`'s estimate on the kept set."""
    with torch.no_grad(), f32_geometry():
        keep, deg = gnc.compatibility_core(src, dst, valid, NOISE_BOUND)
        init = gnc._tim_pose(src, dst, keep, deg, NOISE_BOUND)
        return gnc_pose(src, dst, keep, noise_bound=NOISE_BOUND, init_transform=init)


def test_teaser_replay_equals_the_eager_pose_bit_for_bit(card):
    """Two batches of one shape (a capture, then a replay on new inputs)
    and a second shape (a second capture), each against the reference's
    early-exit polish and against the captured body run eagerly (autograd
    on takes that route)."""
    results = []
    for seed, (b, n) in enumerate([(16, 512), (16, 512), (8, 768)]):
        src, dst, valid = _matches(100 + seed, b, n, card)
        with torch.no_grad():
            t, w = teaser_pose(src, dst, valid, noise_bound=NOISE_BOUND)
        want_t, want_w = _early_exit_teaser(src, dst, valid)
        body_t, body_w = teaser_pose(src, dst, valid, noise_bound=NOISE_BOUND)
        torch.cuda.synchronize()
        assert torch.equal(t, want_t) and torch.equal(w, want_w), (b, n)
        assert torch.equal(t, body_t) and torch.equal(w, body_w), (b, n)
        key = _teaser_key(src, dst, valid)
        results.append((key, gnc._GRAPHS.entries[key], t))
    (k0, g0, t0), (k1, g1, t1), (k2, g2, _) = results
    assert k0 == k1 and g0 is g1
    assert not torch.equal(t0, t1)
    assert k2 != k0 and g2 is not g0


def test_a_capture_leaves_nothing_outside_its_graphs_pool(card):
    """The warm-up runs in the graph's own pool, so the first call of a
    shape grows the allocator's reserve by that pool and the small copies
    of inputs and outputs alone (a warm-up on a stream of its own would
    leave its blocks cached there, several times the slack here)."""
    src, dst, valid = _matches(51, 16, 1024, card)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved(card)
    with torch.no_grad():
        teaser_pose(src, dst, valid, noise_bound=NOISE_BOUND)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_reserved(card) - before
    pool_id = gnc._GRAPHS.entries[_teaser_key(src, dst, valid)].pool.id
    pool = sum(s["total_size"] for s in torch.cuda.memory._snapshot()["segments"]
               if tuple(s["segment_pool_id"]) == tuple(pool_id))
    assert pool > 0 and grown <= pool + 32 * 2**20, (grown, pool)


def test_teaser_pose_makes_no_host_sync(card):
    """The first call of a shape (the warm-up and the capture) and a replay
    under CUDA's sync debug mode "error"."""
    src, dst, valid = _matches(21, 8, 1024, card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            first = teaser_pose(src, dst, valid, noise_bound=NOISE_BOUND)
            again = teaser_pose(src, dst, valid, noise_bound=NOISE_BOUND)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    assert bool(torch.isfinite(first[0]).all())


def test_teaser_pose_inside_a_callers_capture_stays_eager(card):
    """A caller that captures teaser_pose in its own graph gets its body
    eagerly (no host read): no graph of gnc.py's is made for the shape,
    and the caller's replay gives the eager pose."""
    src, dst, valid = _matches(31, 4, 448, card)
    want_t, want_w = _early_exit_teaser(src, dst, valid)
    with torch.no_grad():
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            t, w = teaser_pose(src, dst, valid, noise_bound=NOISE_BOUND)
        assert _teaser_key(src, dst, valid) not in gnc._GRAPHS.entries
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(t, want_t) and torch.equal(w, want_w)


def test_teaser_replay_counts_one_replay_and_the_polish_iterations(card):
    """After the capture, a traced call adds 1 to `gnc.graph_replays` and
    100 to `gnc.iterations`, captures nothing and reads nothing on the
    host."""
    src, dst, valid = _matches(41, 8, 384, card)
    with torch.no_grad():
        teaser_pose(src, dst, valid, noise_bound=NOISE_BOUND)
        tracing.reset()
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                teaser_pose(src, dst, valid, noise_bound=NOISE_BOUND)
            counters = tracing.snapshot()["counters"]
        finally:
            tracing.reset()
    assert counters.get("gnc.graph_replays") == 1
    assert counters.get("gnc.iterations") == gnc.POLISH_ITERATIONS == 100
    assert "gnc.graph_captures" not in counters and "host.syncs" not in counters
