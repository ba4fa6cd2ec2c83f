"""Profiling and tracing, twin of `rift_tpu/train/profiling.py`, on
`torch.profiler`: `trace(log_dir)` captures the host and, where CUDA is
available, the card's kernels around a block and writes a Chrome trace
into `log_dir`; `annotate(name)` is a named range in that trace
(`record_function`); `StepTimer` times steps on the host clock, waiting
for the card's work on the measured result before it reads the clock,
and drops its first `warmup` steps.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


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
