"""Benchmark: the differentiable rasterizer's forward+backward throughput
in rays/s, the port's counterpart of ``bench.py``.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline", ...} (the
JAX tool's four keys first) and, on an earlier stderr line, the binning's
overflow counters and pairs.

``vs_baseline`` normalises against 15e6 rays/s: the reference CUDA
pipeline's implied training throughput on an RTX A6000 (about 30k
iterations in about 55 min at about 1.5 MP, as ``bench.py`` derives it),
not a TPU's figure.

The config is ``bench.py``'s, kept fixed for comparability: a 512x512
view of 32,768 random Gaussians through the padded kernels (K5, K1, K2) at
``max_dup`` 32 and K = 384.  It truncates: the dense toy view keeps more
pairs a tile than K, and the counters printed say by how much.

A run is ``ITERS`` gradient steps of mean|render| + 0.1 mean(depth) with
respect to all five inputs, each step's means moved by its own epsilon in
[1e-6, 2e-6) and the grads accumulated.  ``value`` is from the best of 3
runs after 3 warm-ups, on the host's clock around a synchronised run;
``device_ms`` is ``profiling.device_ms`` per step (with the host's cost
where the host is the slower), ``device_busy_ms`` the device-side events
of a profiled run per step::

    python -m street_sparse_3dgs_tpu_torch.tools.bench [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys

import torch

from ..data.toy import make_toy_scene
from ..device import resolve_device
from ..ops.rasterize import RasterConfig
from .bench_street import (BASELINE_RAYS_S, best_of, epsilons, grad_steps,
                           stats)

H, W = 512, 512
N_GAUSS = 32768
WARMUP = 3
ITERS = 20
CONFIG = RasterConfig(method="pallas", max_dup=32, tile_capacity=384)


def _watchdog() -> None:
    """Fail fast (non-zero exit, no fake metric) if the card hangs."""
    budget = int(os.environ.get("BENCH_TIMEOUT_S", "2400"))

    def _bail(signum, frame):
        print(f"bench: no result within {budget}s (CUDA card unreachable "
              "or hung?)", file=sys.stderr)
        os._exit(3)

    signal.signal(signal.SIGALRM, _bail)
    signal.alarm(budget)


def bench(dev: torch.device, n: int = N_GAUSS, res: int = H,
          iters: int = ITERS, warmup: int = WARMUP, profile: bool = True,
          scene=None) -> dict:
    """The benchmark on ``dev``: the JSON record (JAX's keys first, then the
    step ms, device ms, overflow counters, pairs), with the accumulated
    grads under ``"grads"``."""
    if scene is None:
        scene = make_toy_scene(seed=0, n=n, n_cameras=1, width=res,
                               height=res, device=dev)
    cam = scene.cameras[0]
    rows = (scene.means3d, scene.scales, scene.quats, scene.opacities,
            scene.sh_coeffs)
    bg = torch.zeros(3, device=dev)
    gt = torch.zeros(3, res, res, device=dev)
    s = stats(rows, cam, CONFIG)
    print(f"dup_overflow {s['dup_overflow']} tile_overflow "
          f"{s['tile_overflow']} pairs {s['pairs']} (K = "
          f"{CONFIG.tile_capacity}, max_dup {CONFIG.max_dup}: the config "
          f"truncates {s['tile_overflow'] + s['dup_overflow']} pairs a step)",
          file=sys.stderr, flush=True)
    eps = epsilons(iters, dev)
    last = {}

    def run():
        grads, over = grad_steps(rows, [cam], eps, CONFIG, bg, gt)
        last.update(grads=grads, over=over)

    best = best_of(run, dev, warmup)
    rays_s = res * res * iters / best
    rec = {
        "metric": "rasterizer_fwd_bwd_rays_per_s",
        "value": round(rays_s, 1),
        "unit": "rays/s/chip",
        "vs_baseline": round(rays_s / BASELINE_RAYS_S, 4),
        "step_ms": best / iters * 1e3,
        "device_ms": None, "device_busy_ms": None, "device_idle_share": None,
        "dup_overflow": s["dup_overflow"],
        "tile_overflow": s["tile_overflow"], "pairs": s["pairs"],
        "visible": s["n_visible"],
        "step_dup_overflow_max": last["over"]["dup_overflow"],
        "step_tile_overflow_max": last["over"]["tile_overflow"],
        "grads_finite": all(bool(torch.isfinite(g).all())
                            for g in last["grads"]),
    }
    if dev.type == "cuda":
        from ..profiling import device_ms, device_summary, trace_fn
        rec["device_ms"] = device_ms(run, 1) / iters
        if profile:
            summ = device_summary(trace_fn(run, iters=1, warmup=0,
                                           device=dev))
            rec["device_busy_ms"] = summ["device_busy_ms"] / iters
            rec["device_idle_share"] = summ["device_idle_share"]
    return {**rec, "grads": last["grads"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    _watchdog()
    try:
        rec = bench(dev)
    finally:
        signal.alarm(0)
    print(json.dumps({k: v for k, v in rec.items() if k != "grads"}),
          flush=True)
    return rec


if __name__ == "__main__":
    main()
