"""One run of one benchmark cell of rift_tpu_torch on CUDA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is a workload of `BENCHMARK.json`. Set-up builds the cell from its
files (`harness.py`): the weights and inputs from the seed on the card, and
a warm-up of the cell's own shapes; `setup_s` runs from the start of this
script to the first timed call. The window then drives the cell's entry
back to back, one call in flight, for `--seconds`. With `--trace 0` the
result holds the cell's end-to-end metrics; with `--trace 1` the window
(cut to the traffic's `trace_calls`) runs under `torch.profiler` and the
result holds its per-layer metrics, the device's busy and window seconds
and a breakdown. After the window the program's state is freed and the
plain reference checks the answers of the sampled calls; each number
compared is printed beside its limit, last on standard error and under
the result's last key, `checks`.

The last line of standard output is the result, one JSON object:
`correct`, `attempted` (calls in the window), `failed` (sampled calls that
fail a comparison), `metrics`, `device`, with --trace 1 `breakdown`, and
`checks`. The run fails with no result where there is no CUDA card or
fewer cards than the cell asks for, and where JAX or the JAX package was
loaded. A cell on several cards runs one process a card (this one is rank
0), over NCCL at a free localhost port.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from datetime import timedelta  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def parse(argv: list[str] | None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.split("\n")
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out[0].strip() or None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_rank(rank: int, world: int, args: argparse.Namespace, spec: harness.CellSpec,
             port: int | None, device_type: str = "cuda") -> dict | None:
    """Build, measure and check the cell on card `rank`; rank 0 returns the
    result, the others None. `device_type="cpu"` (gloo between ranks) is
    for the tests alone: the benchmark runs on the cards."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from benchmark import trace

    cuda = device_type == "cuda"
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(device)
    group = ctrl = None
    if world > 1:
        dist.init_process_group("nccl" if cuda else "gloo",
                                init_method=f"tcp://localhost:{port}", world_size=world,
                                rank=rank, timeout=timedelta(seconds=300))
        group = dist.group.WORLD
        ctrl = dist.new_group(backend="gloo", timeout=timedelta(seconds=300)) if cuda else group

    def sync():
        if cuda:
            torch.cuda.synchronize(device)
        if ctrl is not None:
            dist.barrier(group=ctrl)

    def keep_going(more: bool) -> bool:
        flag = [more]
        dist.broadcast_object_list(flag, src=0, group=ctrl)
        return bool(flag[0])

    ctx = harness.Context(spec, args.seed, device, rank, world, group)
    t_build = time.perf_counter()
    cell = harness.load_piece("drivers", spec.traffic["driver"]).build(ctx)
    sync()
    setup_s = time.perf_counter() - T_START
    if rank == 0:
        parts = {"start_s": t_build - T_START, **getattr(cell, "setup_parts", {})}
        print("setup parts: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()),
              file=sys.stderr)
    first = getattr(cell, "calls_in_setup", 0)
    summary = None
    if args.trace:
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities) as prof:
            window = harness.run_window(cell, args.seconds, first, sync,
                                        keep_going if ctrl else None,
                                        max_calls=spec.traffic.get("trace_calls"))
        summary = trace.summarize(trace.raw_events(prof))
        del prof
    else:
        window = harness.run_window(cell, args.seconds, first, sync,
                                    keep_going if ctrl else None)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    cell.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = cell.check() if rank == 0 else []
    peaks, summaries = [peak], [summary]
    if ctrl is not None:
        peaks, summaries = [None] * world, [None] * world
        dist.all_gather_object(peaks, peak, group=ctrl)
        dist.all_gather_object(summaries, summary, group=ctrl)
        dist.barrier(group=ctrl)
        dist.destroy_process_group()
    if rank != 0:
        return None

    found = harness.forbidden_modules()
    if found:
        print(f"error: the run loaded {', '.join(found)}", file=sys.stderr)
        return None
    run = harness.Run(spec, window, setup_s, world,
                      torch.cuda.get_device_name(device) if cuda else "cpu",
                      _power_limit() if cuda else None, summary, summaries)
    metrics = harness.read_metrics(run, spec.per_layer if args.trace else spec.end_to_end)
    return harness.result(run, checks, metrics, max(peaks))


def _rank_main(rank: int, world: int, argv: list[str], port: int) -> None:
    """Entry of the process of card `rank` > 0."""
    os.environ.update(harness.cache_environment())
    args = parse(argv)
    run_rank(rank, world, args, harness.resolve(args.workload), port)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    spec = harness.resolve(args.workload)
    os.environ.update(harness.cache_environment())
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"error: {spec.name} needs {spec.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    procs = []
    try:
        port = None
        if spec.chips > 1:
            import multiprocessing

            mp = multiprocessing.get_context("spawn")
            port = _free_port()
            procs = [mp.Process(target=_rank_main, args=(r, spec.chips, argv, port))
                     for r in range(1, spec.chips)]
            for p in procs:
                p.start()
        result = run_rank(0, spec.chips, args, spec, port)
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
    if result is None or any(p.exitcode != 0 for p in procs):
        return 1
    for name, c in result["checks"].items():
        ok = isinstance(c["value"], float) and c["value"] <= c["limit"]
        print(f"check {name} = {c['value']!r} limit {c['limit']!r} {'ok' if ok else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
