"""Tracing of the port: the profiler helpers (twins of
`rift_tpu/train/profiling.py`) and a recorder of spans and counters at the
registration path's stage boundaries.

`trace(log_dir)` captures the host and, where CUDA is available, the card's
kernels around a block and writes a Chrome trace into `log_dir`;
`annotate(name)` is a named range in that trace (`record_function`);
`StepTimer` times steps on the host clock, waiting for the card's work on
the measured result before it reads the clock, and drops its first
`warmup` steps.

`span(name, device)` and `count(name, n)` record only while a
`torch.profiler` window is open (`trace`, or any `profile`); outside one
each costs one check. A recorded span is a `cpu_op` range of the
profiler's trace (no copy on the device's timeline), its host time (total,
and self: less what its child spans cover), with a CUDA `device` its extent
on the current stream between two timing events, and, where it has no
parent span, the allocator's growth in device allocations (the counter
`cuda.mallocs`). The events are read in `snapshot()`, after the window, so
recording adds no host sync. `snapshot()` returns the totals since the
last `reset()`:

    {"spans": {name: {"count", "host_s", "host_self_s", "device_s", "parent"}},
     "counters": {name: n}, "launches": {kernel: launches}}

`device_s` is None for a span that recorded no events (on the CPU, or
inside a CUDA graph capture); `parent` is the enclosing span's name at the
first record; `launches` are the hand-written kernels' counts as their
wrappers keep them (`ops/cuda/__init__.py:kernel_wrappers`).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_profiler_enabled = torch._C._autograd._profiler_enabled
# A range recorded as a `cpu_op`: `record_function`'s user annotation gets a
# copy on the device's timeline, which reads as a device operation.
_FastRange = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; yields the profiler (`key_averages()` and
    `events()` read it after the block). The trace is written to
    `log_dir/trace.json` (view it in chrome://tracing or Perfetto)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named range that shows up in `trace`'s trace around the work
    enqueued inside it."""
    return record_function(name)


def _cuda_devices(tree) -> set:
    """The CUDA devices of the tensors in a tensor, list, tuple or dict."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*(_cuda_devices(t) for t in tree)) if tree else set()
    return set()


class StepTimer:
    """Host-clock step times with the first `warmup` dropped."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times: list[float] = []
        self._count = 0

    @contextlib.contextmanager
    def measure(self, result=None):
        """Time the block. `result` (tensors, or a list or dict of them,
        filled in by the block) names the work to wait for: each CUDA
        device it lives on is synchronized before the clock is read."""
        t0 = time.perf_counter()
        yield
        for device in _cuda_devices(result):
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)

    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    def summary(self) -> dict:
        if not self.times:
            return {"mean_s": 0.0, "min_s": 0.0, "count": 0}
        return {"mean_s": self.mean(), "min_s": min(self.times), "count": len(self.times)}


def _device_allocs(device: torch.device) -> int:
    """The caching allocator's count of device allocations (cudaMalloc)."""
    return torch.cuda.memory_stats_as_nested_dict(device)["num_device_alloc"]


class _Stat:
    __slots__ = ("count", "host_ns", "self_ns", "device_ms", "parent")

    def __init__(self, parent: str | None):
        self.count = self.host_ns = self.self_ns = 0
        self.device_ms = None
        self.parent = parent


class _Span:
    """One recorded span; `Recorder.span` makes it while a profiler runs."""

    __slots__ = ("rec", "name", "device", "range", "events", "allocs", "t0", "child_ns",
                 "parent")

    def __init__(self, rec: Recorder, name: str, device: torch.device | None):
        self.rec, self.name, self.device = rec, name, device
        self.range = _FastRange(name)
        self.events = self.allocs = None
        self.child_ns = 0

    def __enter__(self):
        stack = self.rec._stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.range.__enter__()
        dev = self.device
        if dev is not None and not torch.cuda.is_current_stream_capturing():
            stream = torch.cuda.current_stream(dev)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(stream)
            if self.parent is None:
                self.allocs = _device_allocs(dev)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.t0
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        growth = None if self.allocs is None else _device_allocs(self.device) - self.allocs
        self.range.__exit__(*exc)
        self.rec._stack().pop()
        if self.parent is not None:
            self.parent.child_ns += dur
        self.rec._close(self, dur, growth)
        return False


class Recorder:
    """Spans and counters of one process (see the module's docstring); the
    module's `span`, `count`, `snapshot` and `reset` use one shared
    recorder."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self.reset()

    def reset(self) -> None:
        """Forget every span, counter and pending event."""
        with self._lock:
            self._spans: dict[str, _Stat] = {}
            self._counters: dict[str, int] = {}
            self._pending: list[tuple[str, torch.cuda.Event, torch.cuda.Event]] = []

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, device=None):
        """A context manager that records the block as the span `name`
        while a profiler runs, with device timing events where `device`
        is a CUDA device; a shared no-op otherwise."""
        if not _profiler_enabled():
            return _OFF
        if device is not None:
            device = torch.device(device)
            if device.type != "cuda":
                device = None
        return _Span(self, name, device)

    def count(self, name: str, n: int = 1) -> None:
        """Add `n` to the counter `name` while a profiler runs."""
        if _profiler_enabled():
            with self._lock:
                self._counters[name] = self._counters.get(name, 0) + n

    def _close(self, s: _Span, dur: int, growth: int | None) -> None:
        with self._lock:
            stat = self._spans.get(s.name)
            if stat is None:
                stat = self._spans[s.name] = _Stat(s.parent.name if s.parent else None)
            stat.count += 1
            stat.host_ns += dur
            stat.self_ns += dur - s.child_ns
            if s.events is not None:
                self._pending.append((s.name, *s.events))
            if growth is not None:
                self._counters["cuda.mallocs"] = self._counters.get("cuda.mallocs", 0) + growth

    def snapshot(self) -> dict:
        """The totals since `reset()`; waits for the pending timing
        events, so call it after the window."""
        with self._lock:
            pending, self._pending = self._pending, []
            for name, start, end in pending:
                end.synchronize()
                stat = self._spans[name]
                stat.device_ms = (stat.device_ms or 0.0) + start.elapsed_time(end)
            spans = {name: {"count": s.count, "host_s": s.host_ns * 1e-9,
                            "host_self_s": s.self_ns * 1e-9,
                            "device_s": None if s.device_ms is None else s.device_ms * 1e-3,
                            "parent": s.parent}
                     for name, s in self._spans.items()}
            counters = dict(self._counters)
        from .ops.cuda import kernel_wrappers

        launches = {name: fn.launches for name, fn in kernel_wrappers().items()}
        return {"spans": spans, "counters": counters, "launches": launches}


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
snapshot = RECORDER.snapshot
reset = RECORDER.reset
