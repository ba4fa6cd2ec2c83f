"""GNC robust poses and the TEASER-style pipeline, twins of
`rift_tpu/registration/gnc.py` (`gnc_pose` with `kind="tls"` on both
schedules and with `kind="gm"`, `fgr_pose`, `compatibility_core`,
`_rotation_gnc_tls`, `_masked_component_median`, `teaser_pose`), batched
over pairs.

`gnc_pose`, kind "tls": each iteration updates the TLS weights (Yang et
al. 2020, eq. 14) from the residuals of the current transform, re-solves
a weighted Kabsch, and grows μ by `gnc_factor`. With `early_exit` (the
default) a pair stops at its fixed point — the first iteration whose
weights repeat the previous ones — or after `max_iterations`; a stopped
pair keeps its carry while the others go on, as the reference's vmapped
`lax.while_loop` does, and the loop tests on the host whether any pair is
still active, once an iteration (the `tracing` counter `host.syncs`; the
iterations run are `gnc.iterations`). Without it, every pair runs
`max_iterations` iterations with no exit test and nothing read on the
host, as the reference's `lax.scan`. Kind "gm"
(FGR's graduated Geman-McClure, `fgr_pose`): `max_iterations` fixed
iterations with w = (μc²/(μc² + r²))², μ from 64 down by `gnc_factor` to
1; no early exit, so no host sync.

Why the two TLS schedules agree: a pair stops at the first iteration whose
weights repeat the previous ones, and the Kabsch from the same weights is
the same transform. A weight strictly between 0 and 1 changes with μ, so a
repeat holds where every weight is 0 or 1; as μ grows, th2 = μ/(μ+1)·c²
rises and th1 = (μ+1)/μ·c² falls, so r² ≤ th2 and r² ≥ th1 stay so, and
every later iteration repeats the fixed point bit for bit.

On a CUDA device, with autograd off and outside another stream's capture,
a fixed schedule replays a CUDA graph of its own body instead of launching
its ~100-200 kernels an iteration from the host. `_Graph` captures a
function over static copies of its input tensors: a warm-up, then
`capture_begin`/`capture_end`, both on one side stream per device and in
the graph's own memory pool, so the warm-up's blocks are the capture's and
leave nothing behind in the allocator's cache. A call copies the inputs in,
replays once and returns copies of the outputs. The graphs are kept in a
cache of `GRAPHS_KEPT` by `_graph_key`: the function, the inputs' devices,
shapes and dtypes, the schedule's numbers and the TF32 flag. A replay runs
the same kernels in the same order, so its results are the eager code's
bit for bit. Two functions are captured: TLS's fixed schedule from the
plain Kabsch (`gnc_pose(early_exit=False)`), and `teaser_pose` whole. The
`tracing` counters: `gnc.graph_captures` a capture, `gnc.graph_replays` a
replay, and the replay's iterations in `gnc.iterations`.

`teaser_pose`: the degree core of the TIM compatibility graph, rotation
GNC-TLS on translation-invariant measurements from the core's max-degree
anchor, the median translation, then the GNC-TLS polish from that estimate
on the kept set, on TLS's fixed schedule (`POLISH_ITERATIONS`), which ends
where the reference's early exit stops (above). The whole pose has fixed
shapes and reads nothing on the host: one graph a shape where a graph can
replay, the same code eagerly elsewhere (the CPU, autograd, a caller's own
capture).
"""
from __future__ import annotations

import collections

import torch

from .. import tracing
from ..ops.neighbors import pairwise_sqdist
from ..ops.precision import f32_geometry
from .kabsch import rotation_from_h, weighted_kabsch

Tensor = torch.Tensor


def _residuals(transform: Tensor, src: Tensor, dst: Tensor) -> Tensor:
    rot = transform[..., :3, :3]
    t = transform[..., :3, 3]
    moved = torch.matmul(src, rot.transpose(-1, -2)) + t[..., None, :]
    return torch.linalg.vector_norm(moved - dst, dim=-1)


def _tls_weights(transform, mu, src, dst, valid, c2):
    return _tls(_residuals(transform, src, dst) ** 2, mu[..., None], c2) * valid


def _tls(r2: Tensor, mu: Tensor, c2: float) -> Tensor:
    """The TLS weight of each squared residual r2 [b, n] at μ [b, 1]."""
    th1 = (mu + 1.0) / mu * c2
    th2 = mu / (mu + 1.0) * c2
    mid = torch.sqrt(c2 * mu * (mu + 1.0) / torch.clamp(r2, min=1e-20)) - mu
    return torch.where(r2 >= th1, torch.zeros_like(r2),
                       torch.where(r2 <= th2, torch.ones_like(r2), mid))


def _mu0(r2_max: Tensor, c2: float) -> Tensor:
    """TEASER's initial μ from the largest valid squared residual."""
    return torch.clamp(c2 / torch.clamp(2.0 * r2_max - c2, min=1e-12), min=1e-6)


def _tls_mu0(transform: Tensor, src: Tensor, dst: Tensor, valid: Tensor, c2: float) -> Tensor:
    """μ's start [b] from the residuals of the start transform."""
    r2 = _residuals(transform, src, dst) ** 2
    return _mu0(torch.where(valid > 0, r2, torch.zeros_like(r2)).amax(-1), c2)


def _tls_fixed(src: Tensor, dst: Tensor, valid: Tensor, c2: float, gnc_factor: float,
               iterations: int, init_transform: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """TLS's fixed schedule: `iterations` iterations from `init_transform`
    (by default the plain Kabsch on `valid`, [b, n] in src's dtype), with
    no host read."""
    transform = weighted_kabsch(src, dst, valid) if init_transform is None else init_transform
    mu = _tls_mu0(transform, src, dst, valid, c2)
    w = valid
    for _ in range(iterations):
        w = _tls_weights(transform, mu, src, dst, valid, c2)
        transform = weighted_kabsch(src, dst, w)
        mu = mu * gnc_factor
    return transform, w


GRAPHS_KEPT = 4  # captured graphs kept; the least recently used goes first


class _Bounded:
    """A cache of at most `size` entries that drops the least recently used."""

    def __init__(self, size: int):
        self.size = size
        self.entries: collections.OrderedDict = collections.OrderedDict()

    def get(self, key, make):
        """The entry of `key`, made by `make()` where there is none."""
        entry = self.entries.get(key)
        if entry is None:
            entry = self.entries[key] = make()
            if len(self.entries) > self.size:
                self.entries.popitem(last=False)
        else:
            self.entries.move_to_end(key)
        return entry


_GRAPHS = _Bounded(GRAPHS_KEPT)


def _replays(src: Tensor) -> bool:
    """Whether a fixed-shape body replays a captured graph: on a CUDA
    device, with autograd off, and outside another capture (a caller that
    captures `gnc_pose` or `teaser_pose` in a graph of its own gets the
    eager code)."""
    return (src.is_cuda and not torch.is_grad_enabled()
            and not torch.cuda.is_current_stream_capturing())


def _graph_key(fn, inputs: tuple, *numbers) -> tuple:
    """What a capture of `fn(*inputs, *numbers)` is specific to: the
    function, each input's device, shape and dtype, the numbers, and the
    TF32 matmul flag (`f32_geometry` clears it; the captured matmuls follow
    it)."""
    return (fn, *((x.device, tuple(x.shape), x.dtype) for x in inputs), *numbers,
            torch.backends.cuda.matmul.allow_tf32)


_SIDE_STREAMS: dict = {}  # device -> the stream every capture on it runs on


class _Graph:
    """`fn(*inputs, *numbers)` captured as one CUDA graph on static copies
    of the input tensors. `fn` reads nothing on the host and returns a
    tuple of tensors. The capture runs `fn` once eagerly (cuBLAS's handle
    and workspace for the stream), then captures it; both on the device's
    side stream and in the graph's pool, so the capture reuses the
    warm-up's blocks and nothing is left cached on the side stream."""

    def __init__(self, fn, inputs: tuple, numbers: tuple):
        self.inputs = tuple(x.clone() for x in inputs)
        device = self.inputs[0].device
        stream = torch.cuda.current_stream(device)
        side = _SIDE_STREAMS.get(device)
        if side is None:
            side = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
        side.wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):  # also the current device
            self.pool = torch.cuda.MemPool()
            with torch.cuda.use_mem_pool(self.pool):
                fn(*self.inputs, *numbers)
            # Not `torch.cuda.graph`: its entry empties the allocator's
            # cache, which the next call would then refill by cudaMalloc.
            self.graph.capture_begin(pool=self.pool.id)
            try:
                self.outputs = fn(*self.inputs, *numbers)
            finally:
                self.graph.capture_end()
        stream.wait_stream(side)
        tracing.count("gnc.graph_captures")

    def __call__(self, *inputs: Tensor) -> tuple:
        """Replay on these inputs: copies in, one graph launch, copies of
        the outputs (the next replay overwrites the static ones)."""
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)
        self.graph.replay()
        tracing.count("gnc.graph_replays")
        return tuple(t.clone() for t in self.outputs)


def _replayed(fn, inputs: tuple, *numbers) -> tuple:
    """`fn(*inputs, *numbers)` by one replay of its graph, captured at the
    first call of its `_graph_key`."""
    key = _graph_key(fn, inputs, *numbers)
    return _GRAPHS.get(key, lambda: _Graph(fn, inputs, numbers))(*inputs)


def gnc_pose(src: Tensor, dst: Tensor, valid: Tensor, noise_bound: float = 0.02,
             gnc_factor: float = 1.4, max_iterations: int = 100, kind: str = "tls",
             early_exit: bool = True, init_transform: Tensor | None = None
             ) -> tuple[Tensor, Tensor]:
    """src/dst [b, n, 3] putative matches, valid [b, n] bool ->
    (transform [b, 4, 4], final weights [b, n]). `kind` is "tls" or "gm".
    `early_exit` selects TLS's schedule (the fixed-point exit, or
    `max_iterations` iterations with no host read); "gm" ignores it.
    `init_transform` [b, 4, 4] seeds the iteration (and, for TLS, μ's
    start), by default the plain Kabsch on the valid set. Strict f32 is the
    caller's to set (`ops/precision.py:f32_geometry`, as `register_batch`
    does). The fixed schedule from the plain Kabsch replays a captured CUDA
    graph where `_replays` allows (the module's docstring)."""
    if kind not in ("tls", "gm"):
        raise ValueError(f"unknown GNC kind {kind!r}")
    c2 = noise_bound * noise_bound
    valid = valid.to(src.dtype)
    if kind == "tls" and not early_exit:
        if init_transform is None and _replays(src):
            out = _replayed(_tls_fixed, (src, dst, valid), c2, gnc_factor, max_iterations)
        else:
            out = _tls_fixed(src, dst, valid, c2, gnc_factor, max_iterations, init_transform)
        tracing.count("gnc.iterations", max_iterations)
        return out
    transform = weighted_kabsch(src, dst, valid) if init_transform is None else init_transform
    if kind == "gm":
        return _gm_loop(transform, src, dst, valid, c2, gnc_factor, max_iterations)
    mu = _tls_mu0(transform, src, dst, valid, c2)
    w_prev = valid
    it = 0
    active = torch.ones(src.shape[0], dtype=torch.bool, device=src.device)
    while it < max_iterations:
        tracing.count("host.syncs")
        if not bool(active.any()):
            break
        w = _tls_weights(transform, mu, src, dst, valid, c2)
        new_t = weighted_kabsch(src, dst, w)
        done = (w == w_prev).all(-1) & (it > 0)
        a = active[..., None]
        transform = torch.where(a[..., None], new_t, transform)
        w_prev = torch.where(a, w, w_prev)
        mu = torch.where(active, mu * gnc_factor, mu)
        active = active & ~done
        it += 1
    tracing.count("gnc.iterations", it)
    return transform, w_prev


def _gm_loop(transform: Tensor, src: Tensor, dst: Tensor, valid: Tensor, c2: float,
             gnc_factor: float, iterations: int) -> tuple[Tensor, Tensor]:
    """Graduated Geman-McClure: `iterations` fixed iterations from μ = 64,
    μ ← max(μ/gnc_factor, 1) in f32 after each; returns the last transform
    and the weights it was solved from."""
    mu = torch.full((), 64.0, dtype=src.dtype, device=src.device)
    w = valid
    for _ in range(iterations):
        r2 = _residuals(transform, src, dst) ** 2
        w = (mu * c2 / (mu * c2 + r2)) ** 2 * valid
        transform = weighted_kabsch(src, dst, w)
        mu = torch.clamp(mu / gnc_factor, min=1.0)
    return transform, w


def fgr_pose(src: Tensor, dst: Tensor, valid: Tensor, noise_bound: float = 0.04,
             max_iterations: int = 64) -> tuple[Tensor, Tensor]:
    """FGR-style pose: `gnc_pose(kind="gm")`."""
    return gnc_pose(src, dst, valid, noise_bound=noise_bound, max_iterations=max_iterations,
                    kind="gm")


def compatibility_core(src: Tensor, dst: Tensor, valid: Tensor, noise_bound: float,
                       rounds: int = 4, min_keep: int = 8) -> tuple[Tensor, Tensor]:
    """Degree core of the TIM compatibility graph: src/dst [b, n, 3]
    matched points, valid [b, n] -> (keep bool [b, n], degree [b, n]
    within the kept set).

    Matches i and j are compatible when |‖s_i − s_j‖ − ‖d_i − d_j‖| ≤
    2·noise_bound (both valid, i ≠ j); distances from the
    ‖x‖² + ‖y‖² − 2·x·yᵀ expansion, an f32 matmul (strict under
    `f32_geometry`). Each of `rounds` rounds keeps the vertices whose
    degree among the kept ones is at least half the largest, unless fewer
    than `min_keep` would remain (then the previous set stays)."""
    def pdist(x):
        return torch.sqrt(pairwise_sqdist(x, x))

    n = src.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=src.device)
    compat = ((pdist(src) - pdist(dst)).abs() <= 2.0 * noise_bound) & ~eye
    compat = compat & valid[..., :, None] & valid[..., None, :]
    compat_f = compat.to(src.dtype)

    def degree(keep):
        return torch.matmul(compat_f, keep[..., None])[..., 0] * keep

    keep = valid.to(src.dtype)
    for _ in range(rounds):
        deg = degree(keep)
        thr = 0.5 * deg.amax(-1, keepdim=True)
        new = keep * (deg >= thr).to(src.dtype)
        ok = new.sum(-1, keepdim=True) >= min_keep
        keep = torch.where(ok, new, keep)
    return keep > 0.5, degree(keep)


def _rotation_gnc_tls(v: Tensor, w: Tensor, valid: Tensor, noise_bound: float,
                      gnc_factor: float = 1.4, iterations: int = 40) -> Tensor:
    """Rotation-only GNC-TLS on translation-invariant measurements: v/w
    [b, n, 3] with w ≈ R·v, valid [b, n] -> R [b, 3, 3]. Procrustes
    without centring, `iterations` fixed iterations (no early exit)."""
    c2 = noise_bound * noise_bound
    valid = valid.to(v.dtype)

    def solve(wt):
        h = torch.matmul((v * wt[..., None]).transpose(-1, -2), w)  # Σ wt·v⊗w
        return rotation_from_h(h.transpose(-1, -2))

    rot = solve(valid)
    res0 = torch.linalg.vector_norm(torch.matmul(v, rot.transpose(-1, -2)) - w, dim=-1)
    r2max = torch.where(valid > 0, res0 ** 2, torch.zeros_like(res0)).amax(-1, keepdim=True)
    mu = _mu0(r2max, c2)
    for _ in range(iterations):
        r2 = ((torch.matmul(v, rot.transpose(-1, -2)) - w) ** 2).sum(-1)
        rot = solve(_tls(r2, mu, c2) * valid)
        mu = mu * gnc_factor
    return rot


def _masked_component_median(x: Tensor, valid: Tensor) -> Tensor:
    """Component-wise lower median over the valid rows: x [b, n, c], valid
    [b, n] -> [b, c] (+inf when no row is valid)."""
    big = torch.where(valid[..., None], x, torch.full_like(x, float("inf")))
    srt = torch.sort(big, dim=-2).values
    mid = torch.clamp(valid.sum(-1) - 1, min=0) // 2  # [b]
    return torch.gather(srt, -2, mid[:, None, None].expand(-1, 1, x.shape[-1]))[:, 0]


def _tim_pose(src: Tensor, dst: Tensor, keep: Tensor, deg: Tensor,
              noise_bound: float) -> Tensor:
    """TEASER's estimate from the degree core: the max-degree match as the
    anchor (the first on ties), rotation GNC-TLS on the TIMs
    v_i = s_i − s_a, w_i = d_i − d_a of the other kept matches, then the
    median translation over the kept set -> transform [b, 4, 4]."""
    a = torch.argmax(deg, dim=-1)  # [b]
    anchor = a[:, None, None].expand(-1, 1, 3)
    v = src - torch.gather(src, 1, anchor)
    w = dst - torch.gather(dst, 1, anchor)
    arange = torch.arange(src.shape[1], device=src.device)
    tim_valid = keep & (arange[None, :] != a[:, None])
    # A TIM is the difference of two noisy points: its bound is twice.
    rot = _rotation_gnc_tls(v, w, tim_valid, 2.0 * noise_bound)
    t = _masked_component_median(dst - torch.matmul(src, rot.transpose(-1, -2)), keep)
    init = torch.zeros(src.shape[:1] + (4, 4), dtype=src.dtype, device=src.device)
    init[:, :3, :3] = rot
    init[:, :3, 3] = t
    init[:, 3, 3] = 1.0
    return init


# The polish's schedule: the reference polish's gnc_factor and
# max_iterations (`gnc_pose`'s defaults).
POLISH_FACTOR = 1.4
POLISH_ITERATIONS = 100


def _teaser_fixed(src: Tensor, dst: Tensor, valid: Tensor, noise_bound: float,
                  prune_rounds: int) -> tuple[Tensor, Tensor]:
    """The polished `teaser_pose`: fixed shapes and no host read, so it is
    captured whole."""
    keep, deg = compatibility_core(src, dst, valid, noise_bound, rounds=prune_rounds)
    init = _tim_pose(src, dst, keep, deg, noise_bound)
    return _tls_fixed(src, dst, keep.to(src.dtype), noise_bound * noise_bound, POLISH_FACTOR,
                      POLISH_ITERATIONS, init)


@f32_geometry()
def teaser_pose(src: Tensor, dst: Tensor, valid: Tensor, noise_bound: float = 0.02,
                prune_rounds: int = 4, polish: bool = True) -> tuple[Tensor, Tensor]:
    """TEASER-style pose: `compatibility_core` -> `_tim_pose` -> GNC-TLS
    polish from that estimate on the kept set, on TLS's fixed schedule.
    src/dst [b, n, 3], valid [b, n] -> (transform [b, 4, 4], weights
    [b, n]). The polished pose replays a captured graph where `_replays`
    allows (the module's docstring). Without `polish`, the weights are the
    kept matches within `noise_bound` of the TIM estimate."""
    if polish:
        if _replays(src):
            out = _replayed(_teaser_fixed, (src, dst, valid), noise_bound, prune_rounds)
        else:
            out = _teaser_fixed(src, dst, valid, noise_bound, prune_rounds)
        tracing.count("gnc.iterations", POLISH_ITERATIONS)
        return out
    keep, deg = compatibility_core(src, dst, valid, noise_bound, rounds=prune_rounds)
    init = _tim_pose(src, dst, keep, deg, noise_bound)
    return init, (keep & (_residuals(init, src, dst) <= noise_bound)).to(src.dtype)
