"""The benchmark's run: finds the cell, its configuration, mix, driver
and metrics by the names in ``BENCHMARK.json``, builds the inputs from
the seed, warms up, measures the window, reads the trace (``--trace 1``),
checks the outputs against the plain reference and prints the result
line.  Everything a cell is made of is data or a file of its own:

- ``configs/<file>.json``: the configuration's sizes, its raster and
  optimizer settings (the ``file`` of its ``BENCHMARK.json`` entry);
- ``mixes/<traffic>.json``: the traffic mix, naming its driver
  (``drivers/<driver>.py``), its kind (``traffic/<kind>.py``), its
  parameters and the limits of its check;
- ``metrics/<stem>.py``: the reader of every per-layer metric whose name
  begins with ``<stem>.`` (or is ``<stem>``), ``read(ctx)`` returning a
  number or ``None`` where it finds nothing to read.

A driver reports its end-to-end numbers under the stems of their names:
``frame_ms_p95`` is ``frame_ms_p95.overview`` in a cell that
``BENCHMARK.json`` gives that metric.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "street_sparse_3dgs_tpu")


class RunError(Exception):
    """A run that must end without a result line; ``code`` is its exit
    code."""

    def __init__(self, msg: str, code: int):
        super().__init__(msg)
        self.code = code


def forbidden_modules(names=None) -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the port's name begins with the JAX package's)."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Path | None = None) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` (the checkout's, unless
    ``bench_path`` names another), with its configuration, its mix and the
    metrics it reports; files are found beside that ``BENCHMARK.json``."""
    bench_path = Path(bench_path or ROOT / "BENCHMARK.json")
    root = bench_path.parent
    with open(bench_path) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise RunError(f"unknown workload {name!r}", 2)
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(root / conf["file"]) as f:
        cfg = json.load(f)
    with open(root / "benchmark" / "mixes" / f"{cell['traffic']}.json") as f:
        mix = json.load(f)
    return dict(cell=cell, cfg=cfg, mix=mix, root=root,
                end_to_end=[m for m in bench["end_to_end"]
                            if applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if applies(m, name)])


def stem(name: str) -> str:
    return name.split(".")[0]


def metric_module(root: Path, name: str):
    """The reader of per-layer metric ``name`` (``metrics/<stem>.py``):
    ``read(ctx)``, and the ``SPANS`` it needs placed around functions of
    the port."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{stem(name)}",
        root / "benchmark" / "metrics" / f"{stem(name)}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def smi(query: str) -> str | None:
    """``nvidia-smi --query-gpu=<query>`` of the first card, or None where
    it cannot be read."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def require_cards(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise RunError("no CUDA device: this benchmark runs on the card only",
                       3)
    if torch.cuda.device_count() < chips:
        raise RunError(f"{torch.cuda.device_count()} CUDA devices, the cell "
                       f"asks for {chips}", 3)
    return torch.device("cuda", 0)


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# The trace


def _intervals(events):
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _spanned(name: str, fn):
    import torch

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return wrapped


def trace_window(drv, dev, requests: int) -> dict:
    """``requests`` requests under ``torch.profiler``: device busy time
    (the union of device events), the traced window, each kernel's device
    seconds, and the breakdown (the device ops that took most time, the
    longest idle gaps by the host op running when they began)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    snaps = []
    sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(requests):
            snaps.append(drv.snapshot())
            drv.request()
            sync(dev)
        window = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    dev_events = [e for e in events if e.device_type == cuda]
    merged = _intervals(dev_events)
    busy = sum(e - s for s, e in merged) / 1e6
    kernels: dict = {}
    for e in dev_events:
        kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type != cuda
                   and not e.name.startswith("ProfilerStep")),
                  key=lambda x: x[0])
    gaps = sorted(((merged[k + 1][0] - merged[k][1], merged[k][1])
                   for k in range(len(merged) - 1)), reverse=True)[:10]
    idle = []
    for length, at in gaps:
        name = "host"
        for s, e, n in host:
            if s > at:
                break
            if e >= at:
                name = n
        idle.append([name, length / 1e6])
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": window, "requests": requests,
            "kernel_s": kernels, "snapshots": snaps,
            "breakdown": {"device_ops": [[n, s] for n, s in top],
                          "idle_gaps": idle}}


def trace_layers(drv, dev, requests: int, spans: dict) -> dict:
    """Device seconds by layer over ``requests`` more requests: each layer
    of ``spans`` (``{layer: [(module, function), ...]}``, from the
    metrics' files) gets a profiler span around those functions of the
    port for this trace alone, and each kernel counts for the innermost
    span open when the host op that launched it began."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if dev.type != "cuda" or not spans:
        return {}
    undo = []
    for layer, targets in spans.items():
        for modname, attr in targets:
            mod = importlib.import_module(modname)
            orig = getattr(mod, attr)
            setattr(mod, attr, _spanned("layer:" + layer, orig))
            undo.append((mod, attr, orig))
    try:
        sync(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(requests):
                drv.request()
                sync(dev)
    finally:
        for mod, attr, orig in reversed(undo):
            setattr(mod, attr, orig)
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type != cuda]
    opened = sorted((e.time_range.start, e.time_range.end, e.name[6:])
                    for e in events if e.name.startswith("layer:"))
    layers: dict = {}
    for e in events:
        if not e.kernels or e.name.startswith("layer:"):
            continue
        t = e.time_range.start
        inner = None
        for s, end, name in opened:
            if s > t:
                break
            if end >= t:
                inner = name
        if inner is not None:
            layers[inner] = layers.get(inner, 0.0) + sum(
                k.duration for k in e.kernels) / 1e6
    return layers


# ---------------------------------------------------------------------------
# The run


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device=None, bench_path=None) -> dict:
    """One run of a cell; returns the result record.  ``device`` skips the
    look for a card (the CPU tests), ``bench_path`` names another
    ``BENCHMARK.json``."""
    import torch

    torch.set_num_threads(1)
    spec = load_cell(workload, bench_path)
    cell, cfg, mix = spec["cell"], spec["cfg"], spec["mix"]
    dev = device if device is not None else require_cards(cell["chips"])
    drivers = importlib.import_module(f"benchmark.drivers.{mix['driver']}")
    drv = drivers.Driver(cfg, mix, seed, dev)
    drv.setup()
    sync(dev)
    setup_s = time.perf_counter() - t_start

    drv.begin_window()
    latencies = []
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        drv.request()
        sync(dev)
        t1 = time.perf_counter()
        latencies.append(t1 - t)
        if t1 - t0 >= seconds:
            break
    window_s = t1 - t0
    # The card's clock, temperature and draw right after the window.
    card = (smi("clocks.sm,temperature.gpu,power.draw")
            if dev.type == "cuda" else None)
    e2e = dict(drv.end_to_end(latencies, window_s), setup_s=setup_s)
    counters = drv.counters()

    ctx = None
    if trace:
        readers = [metric_module(spec["root"], m["name"])
                   for m in spec["per_layer"]]
        spans: dict = {}
        for r in readers:
            for layer, targets in getattr(r, "SPANS", {}).items():
                known = spans.setdefault(layer, [])
                known.extend(t for t in targets if t not in known)
        ctx = trace_window(drv, dev, mix["trace_requests"])
        ctx["layer_s"] = trace_layers(drv, dev, mix["stack_requests"], spans)
        ctx.update(request_s=window_s / len(latencies),
                   stack_requests=mix["stack_requests"])
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    prog = drv.program_outputs()
    if trace:
        ctx["counts"] = [drv.count(s) for s in ctx.pop("snapshots")]
    drv.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = drv.reference_outputs()
    checks = drv.compare(prog, ref, mix["limits"])
    found = forbidden_modules()
    if found:
        raise RunError("loaded after the window: " + ", ".join(found), 4)

    if trace:
        metrics = {}
        for m, r in zip(spec["per_layer"], readers):
            v = r.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[stem(m["name"])],
                               "unit": m["unit"]}
                   for m in spec["end_to_end"] if stem(m["name"]) in e2e}
    device_rec = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "count": 1, "memory_peak_bytes": int(peak),
        "power_limit": smi("power.limit") if dev.type == "cuda" else None}
    if trace:
        device_rec.update(busy_s=ctx["busy_s"], window_s=ctx["window_s"])
    rec = {"correct": all(v <= lim for _, v, lim in checks),
           "attempted": len(latencies), "failed": counters["failed"],
           "metrics": metrics, "device": device_rec}
    if trace:
        rec["breakdown"] = ctx["breakdown"]
    rec["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    lat = sorted(latencies)
    rec["_stderr"] = dict(counters, window_s=window_s, setup_s=setup_s,
                          request_ms_quartiles=[
                              1e3 * lat[int(q * (len(lat) - 1))]
                              for q in (0, 0.25, 0.5, 0.75, 1)],
                          card=card,
                          memory_peak_bytes=int(peak),
                          **drv.describe(), compared=drv.summary(prog, ref))
    if trace:
        rec["_stderr"].update(layer_s=ctx["layer_s"], counts=ctx["counts"])
    return rec


def emit(rec: dict) -> None:
    """The info lines and the compared numbers on stderr (the numbers
    last), then the result line as the last line of stdout."""
    info = rec.pop("_stderr")
    print("info " + json.dumps(info), file=sys.stderr)
    for name, c in rec["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(rec), flush=True)
