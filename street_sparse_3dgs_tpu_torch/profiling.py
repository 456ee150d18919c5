"""Device profiling: ``torch.profiler`` traces, per-kernel summaries and
CUDA-event timing, the counterpart of ``street_sparse_3dgs_tpu/
profiling.py``.

``trace_fn`` runs a function under ``torch.profiler`` (CUDA activity on a
CUDA device) after warm-up calls outside the trace; ``summarize_trace``
groups the device-side events by name into ms / count rows, with a row for
each program span; ``device_summary`` reads the device busy time and idle
share of a trace; ``event_ms`` times a function with CUDA events,
``device_ms`` its device time alone.  The peaks below are the H100 SXM
data-sheet values (NVIDIA; dense, at the 700 W limit): a card set to a
lower power limit runs below them.

The program measures itself through the second half of the module.
Spans and counters are off unless ``tracing()`` is open:

- ``span(name)`` is a ``torch.profiler.record_function`` while tracing
  (on the profiler's clock with the CUDA runtime calls and kernels), else
  one shared no-op context after a single bool check;
- ``count(name, value)`` adds a Python int on the host, or a tensor's sum
  into a device accumulator (under the span ``trace.count``, never read
  back); ``counters()`` reads every accumulator at once and resets them;
- ``sync_point(name)`` is the span ``sync.<name>`` and a host counter of
  that name around each place where the host waits for the device;
- ``span_table`` reads a finished trace by span: calls, host ms, device ms
  of the kernels launched while the span was the innermost one open (on
  any thread), device-idle ms while it was, and blocking runtime calls,
  with an ``outside`` row for whatever fell under no program span.

Typical use::

    from street_sparse_3dgs_tpu_torch.profiling import (trace_fn,
                                                        summarize_trace,
                                                        print_summary)
    trace = trace_fn(step, state, batch, iters=3)
    print_summary(summarize_trace(trace))
"""

from __future__ import annotations

import bisect
import contextlib
import subprocess
import time
from collections import defaultdict
from typing import Any, NamedTuple, Sequence

import torch

from .device import DEFAULT_DEVICE, resolve_device

PEAK_BYTES_S = 3.35e12      # HBM3
PEAK_FLOP_S = 67e12         # float32 outside the tensor cores


# ---------------------------------------------------------------------------
# Spans and counters inside the program

_ON = False                       # spans and counters record (``tracing``)
_NOOP = contextlib.nullcontext()  # the one span of the off path
SPAN_NAMES: set[str] = set()      # every span name opened while tracing
_HOST: dict[str, int] = {}        # host counters
_DEVICE: dict[str, torch.Tensor] = {}   # device accumulators, int64 0-d


@contextlib.contextmanager
def tracing():
    """Spans and counters record inside the block (they are off outside
    any ``tracing()``)."""
    global _ON
    was, _ON = _ON, True
    try:
        yield
    finally:
        _ON = was


def span(name: str, args: str | None = None):
    """Context of the program span ``name``: a ``record_function`` (with
    ``args`` on the event) while tracing, else one shared no-op."""
    if not _ON:
        return _NOOP
    SPAN_NAMES.add(name)
    return torch.profiler.record_function(name, args)


def count(name: str, value) -> None:
    """Add ``value`` to counter ``name`` while tracing: a Python int on the
    host, or the sum of an integer or bool tensor into an int64
    accumulator on the tensor's device, never read back here (the
    reduction runs under the span ``trace.count``)."""
    if not _ON:
        return
    if isinstance(value, torch.Tensor):
        with span("trace.count"):
            total = torch.sum(value, dtype=torch.int64)
            acc = _DEVICE.get(name)
            _DEVICE[name] = total if acc is None else acc + total
    else:
        _HOST[name] = _HOST.get(name, 0) + int(value)


def sync_point(name: str):
    """Context of a place where the host waits for the device (a read of a
    device value, a copy from pageable host memory): the span
    ``sync.<name>`` and one more on the host counter of that name, while
    tracing."""
    if not _ON:
        return _NOOP
    count("sync." + name, 1)
    return span("sync." + name)


def counters() -> dict[str, int]:
    """Every counter since the last call, by name, and reset them: the
    device accumulators are read once (one host sync a device)."""
    out = dict(_HOST)
    for dev in {v.device for v in _DEVICE.values()}:
        names = [n for n, v in _DEVICE.items() if v.device == dev]
        values = torch.stack([_DEVICE[n] for n in names]).tolist()
        for n, v in zip(names, values):
            out[n] = out.get(n, 0) + v
    _HOST.clear()
    _DEVICE.clear()
    return dict(sorted(out.items()))


# ---------------------------------------------------------------------------
# Traces


class Trace(NamedTuple):
    prof: Any                # the finished torch.profiler.profile
    wall_ms: float           # host clock over the traced calls, synchronised
    iters: int
    counters: dict | None = None   # the program's counters over the calls


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def trace_fn(fn, *args, trace_path: str | None = None, iters: int = 3,
             warmup: int = 1, device: str | torch.device = DEFAULT_DEVICE,
             **kwargs) -> Trace:
    """Run ``fn(*args, **kwargs)`` ``iters`` times under ``torch.profiler``
    and ``tracing()`` (after ``warmup`` calls outside both), with CUDA
    activity on a CUDA ``device``.  ``trace_path`` also writes the Chrome
    trace there."""
    dev = resolve_device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    for _ in range(warmup):
        fn(*args, **kwargs)
    _sync(dev)
    counters()
    with tracing(), torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args, **kwargs)
        _sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace_path:
        prof.export_chrome_trace(trace_path)
    return Trace(prof, wall_ms, iters, counters())


def _device_events(trace: Trace, device_only: bool):
    """The trace's events (device-side ones alone with ``device_only``),
    less the program spans and their device-side copies."""
    return [e for e in trace.prof.events()
            if (not device_only or e.device_type == _CUDA)
            and e.name not in SPAN_NAMES]


def summarize_trace(trace: Trace,
                    device_only: bool = True) -> list[dict[str, Any]]:
    """Events grouped by name -> rows sorted by total time: ``name``,
    ``ms`` and ``count`` per iteration.  ``device_only`` keeps the
    device-side (kernel, memcpy, memset) events; without it, the host ops
    too (a CPU trace has no device events).  Each program span adds a row
    ``span:<name>``: its device ms with its child spans' (``device_only``)
    or its host ms."""
    agg: dict[str, dict[str, float]] = defaultdict(
        lambda: {"us": 0.0, "count": 0})
    for e in _device_events(trace, device_only):
        row = agg[e.name]
        row["us"] += e.time_range.elapsed_us()
        row["count"] += 1
    n = max(1, trace.iters)
    rows = [{"name": name, "ms": r["us"] / 1e3 / n, "count": r["count"] // n}
            for name, r in agg.items()]
    table = span_table(trace.prof)["rows"]
    key = "device_incl_ms" if device_only else "host_ms"
    rows += [{"name": "span:" + name, "ms": r[key] / n,
              "count": r["calls"] // n}
             for name, r in table.items() if name != "outside"]
    rows.sort(key=lambda d: -d["ms"])
    return rows


def device_summary(trace: Trace, top: int = 15) -> dict:
    """Wall ms, device busy ms (the union of the device-side events, so
    that overlapping ones count once) and idle share of a trace, and the
    host ops with the most device self time."""
    busy_ms = _union_us([(e.start, e.end) for e in trace_events(trace.prof)
                         if e.kind == "device"]) / 1e3
    averages = (trace.prof.key_averages()
                if hasattr(trace.prof, "key_averages") else [])
    ops = sorted((e for e in averages if e.device_type != _CUDA),
                 key=lambda e: e.self_device_time_total, reverse=True)[:top]
    return {"profiled_wall_ms": trace.wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / trace.wall_ms,
            "top_device_self_ms": [[e.key, e.self_device_time_total / 1e3,
                                    e.count] for e in ops]}


# ---------------------------------------------------------------------------
# A trace by program span

# Device-side activity that occupies the device (not the annotations the
# profiler also draws there).
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
# Runtime calls that block the host until the device has caught up.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
_CUDA = torch.autograd.DeviceType.CUDA


class Event(NamedTuple):
    """One event of a trace, in microseconds on the trace's host clock.
    ``kind``: ``span`` (a program span), ``device`` (a kernel, copy or
    set on the device; ``launch`` is when the host call that launched it
    began, where the trace links the two), ``sync`` (a blocking runtime
    call) or ``window`` (the extent of the whole trace)."""
    kind: str
    name: str
    start: float
    end: float
    launch: float | None = None


def trace_events(prof, names=None) -> list[Event]:
    """A finished ``torch.profiler.profile`` as ``Event`` s; a list of
    them is returned as it is.  Program spans are the annotations named in
    ``names`` (default: every span opened while tracing)."""
    if isinstance(prof, (list, tuple)):
        return list(prof)
    names = SPAN_NAMES if names is None else set(names)
    raw = prof.profiler.kineto_results.events()
    host_names = {e.name() for e in raw if e.device_type() != _CUDA}
    launched, device, out = {}, [], []
    lo, hi = float("inf"), float("-inf")
    for e in raw:
        t0 = e.start_ns() / 1e3
        t1 = t0 + e.duration_ns() / 1e3
        lo, hi = min(lo, t0), max(hi, t1)
        kind, name = _activity(e, host_names), e.name()
        if kind == "cuda_runtime":
            launched[e.correlation_id()] = t0
            if name in SYNC_CALLS:
                out.append(Event("sync", name, t0, t1))
        elif kind in DEVICE_KINDS:
            device.append((e.correlation_id(), name, t0, t1))
        elif name in names and e.device_type() != _CUDA:
            out.append(Event("span", name, t0, t1))
    out += [Event("device", name, t0, t1, launched.get(c))
            for c, name, t0, t1 in device]
    if lo <= hi:
        out.append(Event("window", "", lo, hi))
    return out


def _activity(e, host_names: set) -> str:
    """The kineto activity type of event ``e``, from its side and name
    (the card's torch 2.11 gives no ``activity_type``): a host event whose
    name begins with ``cuda`` is a runtime call; a device event named as a
    host event is an annotation's device-side copy."""
    if e.device_type() == _CUDA:
        return ("gpu_user_annotation" if e.name() in host_names
                else "kernel")
    return "cuda_runtime" if e.name().startswith("cuda") else "cpu_op"


def _union_us(intervals) -> float:
    return sum(e - s for s, e in _merge(intervals))


def _merge(intervals) -> list[list[float]]:
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def span_table(trace, names=None) -> dict:
    """A trace (a finished profiler or its ``Event`` list) by program span.

    Returns ``window_ms`` (the trace's extent), ``busy_ms`` (the union of
    device events), ``idle_ms`` (the rest) and ``rows``: per span name,
    ``parent`` (its first call's parent span, None at the root),
    ``calls``; ``host_ms`` and ``host_self_ms`` (less the time its child
    spans cover); ``device_ms``, the kernels launched while it was the
    innermost span open, and ``device_incl_ms`` with its child spans';
    ``idle_ms``, device-idle time while it was innermost; ``syncs``,
    blocking runtime calls made while it was innermost.  The innermost
    span at a moment is the shortest program span open then on any thread
    (autograd's thread launches the backward while the caller waits
    inside its span); a span's parent is the shortest that contains it.
    The row ``outside`` holds what fell under no program span (host ms:
    the window less the spans')."""
    evs = trace_events(trace, names)
    spans = sorted((e for e in evs if e.kind == "span"),
                   key=lambda e: (e.start, -e.end))
    window = next((e for e in evs if e.kind == "window"), None)
    lo = window.start if window else min((e.start for e in evs), default=0.0)
    hi = window.end if window else max((e.end for e in evs), default=0.0)
    n = len(spans)
    dur = [e.end - e.start for e in spans]

    # Parents: the shortest span open at a span's start that outlasts it.
    parent: list[int | None] = [None] * n
    open_: list[int] = []
    for i, e in enumerate(spans):
        open_ = [j for j in open_ if spans[j].end > e.start]
        outer = [j for j in open_ if spans[j].end >= e.end]
        if outer:
            parent[i] = min(outer, key=lambda j: dur[j])
        open_.append(i)

    # Elementary segments between span edges, each with its innermost span.
    edges = sorted({lo, hi, *(e.start for e in spans),
                    *(e.end for e in spans)})
    opens, closes = defaultdict(list), defaultdict(list)
    for i, e in enumerate(spans):
        opens[e.start].append(i)
        closes[e.end].append(i)
    seg_start, seg_owner, live = [], [], set()
    for a in edges[:-1]:
        live.update(opens[a])
        live.difference_update(closes[a])
        seg_start.append(a)
        seg_owner.append(min(live, key=lambda i: dur[i]) if live else None)

    def owner(t: float) -> int | None:
        k = bisect.bisect_right(seg_start, t) - 1
        return seg_owner[k] if 0 <= k < len(seg_owner) and \
            t <= edges[k + 1] else None

    device_self = [0.0] * (n + 1)          # the last entry: outside
    idle = [0.0] * (n + 1)
    syncs = [0] * (n + 1)
    busy = []
    for e in evs:
        if e.kind == "device":
            k = owner(e.launch if e.launch is not None else e.start)
            device_self[n if k is None else k] += e.end - e.start
            busy.append((max(e.start, lo), min(e.end, hi)))
        elif e.kind == "sync":
            k = owner(e.start)
            syncs[n if k is None else k] += 1
    merged = _merge(b for b in busy if b[0] < b[1])
    gaps, t = [], lo
    for s, e in merged:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    for a, b in gaps:
        k = max(bisect.bisect_right(seg_start, a) - 1, 0)
        while k < len(seg_start) and seg_start[k] < b:
            cut = min(b, edges[k + 1]) - max(a, seg_start[k])
            if cut > 0:
                o = seg_owner[k]
                idle[n if o is None else o] += cut
            k += 1

    children: list[list[int]] = [[] for _ in range(n)]
    for i, p in enumerate(parent):
        if p is not None:
            children[p].append(i)
    incl = device_self[:n]
    for i in sorted(range(n), key=lambda i: (dur[i], -i)):
        if parent[i] is not None:
            incl[parent[i]] += incl[i]

    rows: dict[str, dict] = {}
    for i, e in enumerate(spans):
        up = None if parent[i] is None else spans[parent[i]].name
        r = rows.setdefault(e.name, dict(
            parent=up, calls=0, host_ms=0.0, host_self_ms=0.0,
            device_ms=0.0, device_incl_ms=0.0, idle_ms=0.0, syncs=0))
        covered = _union_us((max(spans[c].start, e.start),
                             min(spans[c].end, e.end)) for c in children[i])
        r["calls"] += 1
        r["host_ms"] += dur[i] / 1e3
        r["host_self_ms"] += (dur[i] - covered) / 1e3
        r["device_ms"] += device_self[i] / 1e3
        r["device_incl_ms"] += incl[i] / 1e3
        r["idle_ms"] += idle[i] / 1e3
        r["syncs"] += syncs[i]
    roots = _union_us((max(e.start, lo), min(e.end, hi)) for i, e in
                      enumerate(spans) if parent[i] is None)
    outside_host = (hi - lo - roots) / 1e3
    rows["outside"] = dict(parent=None, calls=0, host_ms=outside_host,
                           host_self_ms=outside_host,
                           device_ms=device_self[n] / 1e3,
                           device_incl_ms=device_self[n] / 1e3,
                           idle_ms=idle[n] / 1e3, syncs=syncs[n])
    busy_ms = _union_us(merged) / 1e3
    return {"window_ms": (hi - lo) / 1e3, "busy_ms": busy_ms,
            "idle_ms": (hi - lo) / 1e3 - busy_ms, "rows": rows}


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
