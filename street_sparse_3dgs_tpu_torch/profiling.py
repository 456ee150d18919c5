"""Device profiling: ``torch.profiler`` traces, per-kernel summaries and
CUDA-event timing, the counterpart of ``street_sparse_3dgs_tpu/
profiling.py``.

``trace_fn`` runs a function under ``torch.profiler`` (CUDA activity on a
CUDA device) after warm-up calls outside the trace; ``summarize_trace``
groups the device-side events by name into ms / count rows;
``device_summary`` reads the device busy time and idle share of a trace;
``event_ms`` times a function with CUDA events, ``device_ms`` its device
time alone.  The peaks below are the H100 SXM data-sheet values (NVIDIA;
dense, at the 700 W limit): a card set to a lower power limit runs below
them.

Typical use::

    from street_sparse_3dgs_tpu_torch.profiling import (trace_fn,
                                                        summarize_trace,
                                                        print_summary)
    trace = trace_fn(step, state, batch, iters=3)
    print_summary(summarize_trace(trace))
"""

from __future__ import annotations

import subprocess
import time
from collections import defaultdict
from typing import Any, NamedTuple, Sequence

import torch

from .device import DEFAULT_DEVICE, resolve_device

PEAK_BYTES_S = 3.35e12      # HBM3
PEAK_FLOP_S = 67e12         # float32 outside the tensor cores


class Trace(NamedTuple):
    prof: Any                # the finished torch.profiler.profile
    wall_ms: float           # host clock over the traced calls, synchronised
    iters: int


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def trace_fn(fn, *args, trace_path: str | None = None, iters: int = 3,
             warmup: int = 1, device: str | torch.device = DEFAULT_DEVICE,
             **kwargs) -> Trace:
    """Run ``fn(*args, **kwargs)`` ``iters`` times under ``torch.profiler``
    (after ``warmup`` calls outside the trace), with CUDA activity on a
    CUDA ``device``.  ``trace_path`` also writes the Chrome trace there."""
    dev = resolve_device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    for _ in range(warmup):
        fn(*args, **kwargs)
    _sync(dev)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args, **kwargs)
        _sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace_path:
        prof.export_chrome_trace(trace_path)
    return Trace(prof, wall_ms, iters)


def _device_events(trace: Trace, device_only: bool):
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in trace.prof.events()
            if not device_only or e.device_type == cuda]


def summarize_trace(trace: Trace,
                    device_only: bool = True) -> list[dict[str, Any]]:
    """Events grouped by name -> rows sorted by total time: ``name``,
    ``ms`` and ``count`` per iteration.  ``device_only`` keeps the
    device-side (kernel, memcpy, memset) events; without it, the host ops
    too (a CPU trace has no device events)."""
    agg: dict[str, dict[str, float]] = defaultdict(
        lambda: {"us": 0.0, "count": 0})
    for e in _device_events(trace, device_only):
        row = agg[e.name]
        row["us"] += e.time_range.elapsed_us()
        row["count"] += 1
    n = max(1, trace.iters)
    rows = [{"name": name, "ms": r["us"] / 1e3 / n, "count": r["count"] // n}
            for name, r in agg.items()]
    rows.sort(key=lambda d: -d["ms"])
    return rows


def device_summary(trace: Trace, top: int = 15) -> dict:
    """Wall ms, device busy ms (the sum of the device-side events) and idle
    share of a trace, and the host ops with the most device self time."""
    busy_ms = sum(e.time_range.elapsed_us()
                  for e in _device_events(trace, True)) / 1e3
    cuda = torch.autograd.DeviceType.CUDA
    ops = sorted((e for e in trace.prof.key_averages()
                  if e.device_type != cuda),
                 key=lambda e: e.self_device_time_total, reverse=True)[:top]
    return {"profiled_wall_ms": trace.wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / trace.wall_ms,
            "top_device_self_ms": [[e.key, e.self_device_time_total / 1e3,
                                    e.count] for e in ops]}


def print_summary(rows: Sequence[dict[str, Any]], top: int = 20) -> None:
    print(f"{'ms':>9} {'count':>6}  name")
    for r in rows[:top]:
        print(f"{r['ms']:9.3f} {r['count']:6d}  {r['name'][:100]}")


def event_ms(fn, reps: int) -> float:
    """Mean time of ``fn`` over ``reps`` calls after one warm-up, from CUDA
    events around the whole run: device time, or the host's cost per call
    (Python, the launch) wherever that is the larger, as for a kernel of a
    few microseconds."""
    return _events_ms(fn, reps, 0)


# Clock cycles of the busy-wait ``device_ms`` puts before the timed calls:
# about 20 ms at 1.98 GHz, far longer than the host takes to enqueue them.
_HOLD_CYCLES = 40_000_000


def device_ms(fn, reps: int) -> float:
    """``event_ms`` with the device held busy (``torch.cuda._sleep``) while
    the host enqueues the calls, so that they run back to back and the
    host's cost per call drops out: the device time alone."""
    return _events_ms(fn, reps, _HOLD_CYCLES)


def _events_ms(fn, reps: int, hold_cycles: int) -> float:
    fn()
    torch.cuda.synchronize()
    if hold_cycles:
        torch.cuda._sleep(hold_cycles)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def smi(query: str) -> str:
    """First line of ``nvidia-smi --query-gpu=<query>``, e.g. the card line
    ``smi("name,power.limit")`` that goes beside every number kept."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
