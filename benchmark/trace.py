"""Reduction of a `torch.profiler` trace to what the per-layer metrics read.

The harness wraps every timed call in a `record_function(CALL_SPAN)` span
and traces a window of calls with CPU and CUDA activities. `summarize`
turns the profiler's events into a `TraceSummary`:

- the traced window: from the first call span's start to the last one's
  end;
- every device operation (kernel, copy, set) inside it, by name and time;
- the device's busy time, the union of those intervals, and its idle gaps;
- the kernel launches the host made (`cudaLaunchKernel`,
  `cudaLaunchKernelExC`, and the driver API's; a CUDA graph replay,
  `cudaGraphLaunch`, counts as one);
- for each idle gap, what the host was doing: the innermost CPU operation
  that spans the gap's middle.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

CALL_SPAN = "bench.call"
LAUNCH_NAMES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                          "cuLaunchKernelEx", "cudaGraphLaunch"})
WALK_BACK = 256  # host operations looked through for the one spanning a gap
TOP = 10  # entries of each breakdown list


@dataclass
class TraceSummary:
    """What a traced window holds; times in seconds."""
    calls: int
    window_s: float
    busy_s: float
    launches: int
    device_ops: dict[str, float] = field(default_factory=dict)  # device seconds by name
    idle_by_host_op: dict[str, float] = field(default_factory=dict)

    def device_seconds(self, match) -> float:
        """Device seconds of the operations whose name `match(name)` accepts."""
        return sum(s for name, s in self.device_ops.items() if match(name))

    def breakdown(self) -> dict:
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_by_host_op.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def _ns(event, what: str) -> int:
    """An event's start or duration in ns, across profiler versions."""
    fn = getattr(event, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(event, f"{what}_us")() * 1000)


def _is_device(event) -> bool:
    return str(event.device_type()).endswith("CUDA")


def raw_events(prof) -> list[tuple[str, bool, int, int]]:
    """(name, on the device, start ns, end ns) of every profiler event; a
    span's copy on the device's timeline (`gpu_user_annotation`) is left
    out, since no operation runs in it."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if _is_device(e) and e.name() == CALL_SPAN:
            continue
        start = _ns(e, "start")
        out.append((e.name(), _is_device(e), start, start + _ns(e, "duration")))
    return out


def _union(intervals: np.ndarray) -> np.ndarray:
    """Disjoint sorted intervals [m, 2] covering the given ones."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    merged = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return np.asarray(merged, dtype=np.int64)


def summarize(events: list[tuple[str, bool, int, int]]) -> TraceSummary:
    """The summary of a traced window from `raw_events`."""
    calls = [(s, e) for name, dev, s, e in events if not dev and name == CALL_SPAN]
    if not calls:
        raise RuntimeError(f"the trace holds no {CALL_SPAN!r} span")
    w0, w1 = min(s for s, _ in calls), max(e for _, e in calls)
    dev = [(n, max(s, w0), min(e, w1)) for n, d, s, e in events if d and e > w0 and s < w1]
    ops: dict[str, float] = defaultdict(float)
    for name, s, e in dev:
        ops[name] += (e - s) * 1e-9
    busy = _union(np.asarray([(s, e) for _, s, e in dev], dtype=np.int64).reshape(-1, 2))
    busy_ns = int((busy[:, 1] - busy[:, 0]).sum()) if len(busy) else 0
    launches = sum(1 for n, d, s, _ in events if not d and n in LAUNCH_NAMES and w0 <= s <= w1)
    # Idle gaps: before the first busy interval, between them, after the last.
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    idle = _name_gaps(gaps, [(n, s, e) for n, d, s, e in events
                             if not d and n != CALL_SPAN and w0 <= e and s <= w1])
    return TraceSummary(calls=len(calls), window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9,
                        launches=launches, device_ops=dict(ops), idle_by_host_op=idle)


def _name_gaps(gaps: np.ndarray, host: list[tuple[str, int, int]]) -> dict[str, float]:
    """Idle seconds by the host operation spanning each gap's middle: the
    latest-starting one of those that span it (the innermost, where the
    host's operations nest); "host idle" where none does."""
    out: dict[str, float] = defaultdict(float)
    if len(gaps) == 0:
        return {}
    host = sorted(host, key=lambda h: h[1])
    starts = np.asarray([s for _, s, _ in host], dtype=np.int64)
    ends = np.asarray([e for _, _, e in host], dtype=np.int64)
    mids = (gaps[:, 0] + gaps[:, 1]) // 2
    last = np.searchsorted(starts, mids, side="right") - 1
    for g, j in enumerate(last):
        label = "host idle"
        for k in range(j, max(j - WALK_BACK, -1), -1):
            if ends[k] >= mids[g]:
                label = host[k][0]
                break
        out[label] += (gaps[g, 1] - gaps[g, 0]) * 1e-9
    return dict(out)
