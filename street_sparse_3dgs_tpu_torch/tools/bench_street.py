"""Street-scale rasterizer benchmark (production-profile scene), the port's
counterpart of ``tools/bench_street.py``.

Measures the forward+backward differentiable render at a street-profile
scene (``make_street_scene``) on the card and prints the scene statistics
of camera 0 (stderr), a one-line JSON summary, and with ``--profile`` the
per-kernel device-time breakdown of one timed run, with the program's
spans, its counters a step and the binning scan's yield::

    python -m street_sparse_3dgs_tpu_torch.tools.bench_street \\
        --n 1000000 --width 1920 --height 1088 --max-dup 16 \\
        --tile-capacity 384 --iters 8 --profile

The production exact config::

    ... --two-level --max-dup 2 --tile-capacity 128 --exact-extra 9216 \\
        --dup-overscan 32 --grad-reduce counts --grad-sort bf16

A run is ``--iters`` gradient steps of mean|render| + 0.1 mean(depth) with
respect to the five Gaussian inputs, each step's means moved by its own
epsilon in [1e-6, 2e-6) and the grads accumulated; ``--cameras > 1`` takes
the views round-robin, one a step.  The step time is the best of 3 runs
after ``--warmup`` runs, on the host's clock around a synchronised run;
``device_ms`` is ``profiling.device_ms`` of one run per step.  ``main``
returns the JSON record (and the statistics) to an in-process caller.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..data.toy import make_street_scene
from ..device import resolve_device
from ..ops.binning import bin_gaussians, num_tiles
from ..ops.preprocess import project_gaussians
from ..ops.rasterize import RasterConfig, rasterize

BASELINE_RAYS_S = 15e6
TWO_LEVEL_TAILS = ((262144, 6), (16384, 24), (4096, 224))


def percentile(x: torch.Tensor, q: float) -> float:
    """``jnp.percentile(x, q)``: linear interpolation between the two
    nearest ranks, in f32."""
    return float(torch.quantile(x.to(torch.float32), q / 100.0,
                                interpolation="linear"))


def stats(rows, camera, cfg: RasterConfig) -> dict:
    """Scene statistics of one view: visible rows, binned pairs (the
    pre-clip tile counts), the overflow counters and the occupancy
    mean/p50/p90/max of the tiles, from ``bin_gaussians`` with the knobs of
    ``cfg``."""
    with torch.no_grad():
        proj = project_gaussians(*rows, camera, 3)
        kw = dict(vis_capacity=cfg.vis_capacity, exact_extra=cfg.exact_extra,
                  dup_overscan=cfg.dup_overscan)
        if cfg.dup_tails:
            kw["dup_tails"] = cfg.dup_tails
        bins = bin_gaussians(proj, camera.height, camera.width, cfg.max_dup,
                             cfg.tile_capacity, **kw)
    c = bins.counts.to(torch.float32)
    return dict(n_visible=int(proj.valid.sum()), pairs=int(bins.counts.sum()),
                dup_overflow=int(bins.dup_overflow),
                tile_overflow=int(bins.tile_overflow),
                occ_mean=float(c.mean()), occ_p50=percentile(c, 50),
                occ_p90=percentile(c, 90), occ_max=int(bins.counts.max()))


def epsilons(iters: int, device) -> torch.Tensor:
    """The per-step means perturbations [iters, 1, 1] of the JAX tools:
    ``default_rng(0).uniform(1e-6, 2e-6)`` in f32."""
    return torch.as_tensor(np.random.default_rng(0).uniform(
        1e-6, 2e-6, (iters, 1, 1)), dtype=torch.float32, device=device)


def bench_loss(rows, camera, cfg: RasterConfig, bg, gt):
    """(mean|render - gt| + 0.1 mean(depth), the raster output)."""
    out = rasterize(*rows, camera, 3, bg, cfg)
    return (torch.mean(torch.abs(out["render"] - gt))
            + 0.1 * torch.mean(out["depth"])), out


def grad_steps(rows, cams, eps, cfg: RasterConfig, bg, gt) -> tuple:
    """The grads of the five inputs summed over one step per epsilon (step
    i renders ``cams[i % len(cams)]`` with means + eps[i]), as the JAX
    tools' scan accumulates them; also the largest overflow counters of a
    step.  Returns (grads, {dup_overflow, tile_overflow})."""
    leaves = [x.detach().requires_grad_() for x in rows]
    acc = [torch.zeros_like(x) for x in rows]
    over = {"dup_overflow": 0, "tile_overflow": 0}
    counters = []
    for i, e in enumerate(eps):
        loss, out = bench_loss((leaves[0] + e, *leaves[1:]),
                               cams[i % len(cams)], cfg, bg, gt)
        for a, g in zip(acc, torch.autograd.grad(loss, leaves)):
            a.add_(g)
        counters.append(torch.stack([out["dup_overflow"],
                                     out["tile_overflow"]]))
    worst = torch.stack(counters).amax(dim=0).tolist()
    over.update(dup_overflow=int(worst[0]), tile_overflow=int(worst[1]))
    return acc, over


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def best_of(fn, dev: torch.device, warmup: int, reps: int = 3) -> float:
    """Best host-clock seconds of ``reps`` synchronised calls after
    ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    sync(dev)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def config_of(args) -> RasterConfig:
    return RasterConfig(method=args.method, max_dup=args.max_dup,
                        tile_capacity=args.tile_capacity,
                        vis_capacity=args.vis_capacity or None,
                        grad_sort=args.grad_sort,
                        exact_extra=args.exact_extra,
                        tile_batch=args.tile_batch,
                        grad_reduce=args.grad_reduce,
                        dup_overscan=args.dup_overscan,
                        dup_tails=TWO_LEVEL_TAILS if args.two_level else ())


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1088)
    ap.add_argument("--cameras", type=int, default=1)
    ap.add_argument("--max-dup", type=int, default=16)
    ap.add_argument("--tile-capacity", type=int, default=384)
    ap.add_argument("--vis-capacity", type=int, default=0,
                    help="visible-compaction cap (0 = off)")
    ap.add_argument("--exact-extra", type=int, default=0,
                    help="exact virtual-tile window budget (0 = off)")
    ap.add_argument("--tile-batch", type=int, default=0)
    ap.add_argument("--dup-overscan", type=int, default=0)
    ap.add_argument("--two-level", action="store_true",
                    help="two-level pair emission: the street production "
                         "tail ladder (use with --max-dup 2)")
    ap.add_argument("--method", default="pallas")
    ap.add_argument("--grad-sort", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--grad-reduce", default="sort",
                    choices=["sort", "counts"])
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--stats-only", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default="",
                    help="also append the result line to this file")
    return ap


def main(argv=None, scene=None) -> dict:
    """Run the benchmark; ``scene`` (a ``make_street_scene`` result with at
    least ``--cameras`` views, on the device) skips building it."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.time()
    if scene is None:
        scene = make_street_scene(seed=0, n=args.n,
                                  n_cameras=max(args.cameras, 1),
                                  width=args.width, height=args.height,
                                  device=dev)
    print(f"scene built in {time.time() - t0:.1f}s", file=sys.stderr)
    h, w = args.height, args.width
    cfg = config_of(args)
    rows = (scene.means3d, scene.scales, scene.quats, scene.opacities,
            scene.sh_coeffs)

    s = stats(rows, scene.cameras[0], cfg)
    tx, ty = num_tiles(h, w)
    print(f"tiles {tx}x{ty}={tx * ty}  visible {s['n_visible']}/{args.n}"
          f"  pairs {s['pairs']}  occ mean/p50/p90/max "
          f"{s['occ_mean']:.0f}/{s['occ_p50']:.0f}/{s['occ_p90']:.0f}/"
          f"{s['occ_max']}  dup_of {s['dup_overflow']} "
          f"tile_of {s['tile_overflow']}", file=sys.stderr)
    if args.stats_only:
        return {"stats": s}

    bg = torch.zeros(3, device=dev)
    gt = torch.zeros(3, h, w, device=dev)
    cams = [scene.cameras[i % len(scene.cameras)]
            for i in range(args.cameras)]
    eps = epsilons(args.iters, dev)
    last = {}

    def run():
        grads, over = grad_steps(rows, cams, eps, cfg, bg, gt)
        last.update(grads=grads, over=over)

    t0 = time.time()
    best = best_of(run, dev, args.warmup)
    print(f"warmup+timed {time.time() - t0:.1f}s", file=sys.stderr)
    finite = all(bool(torch.isfinite(g).all()) for g in last["grads"])

    step_ms = best / args.iters * 1e3
    rays_s = h * w * args.iters / best
    rec = {
        "metric": "street_fwd_bwd_rays_per_s",
        "value": round(rays_s, 1),
        "unit": "rays/s/chip",
        "vs_baseline": round(rays_s / BASELINE_RAYS_S, 3),
        "step_ms": round(step_ms, 2),
        "config": {"n": args.n, "res": f"{args.width}x{args.height}",
                   "cameras": args.cameras,
                   "max_dup": args.max_dup, "K": args.tile_capacity,
                   "vis_cap": args.vis_capacity, "method": args.method,
                   "grad_sort": args.grad_sort,
                   "exact_extra": args.exact_extra,
                   "grad_reduce": args.grad_reduce,
                   "two_level": bool(args.two_level),
                   "dup_overscan": args.dup_overscan},
        "pairs": s["pairs"], "visible": s["n_visible"],
        "dup_overflow": s["dup_overflow"],
        "tile_overflow": s["tile_overflow"],
        "step_dup_overflow_max": last["over"]["dup_overflow"],
        "step_tile_overflow_max": last["over"]["tile_overflow"],
        "grads_finite": finite,
        "device_ms": None,
    }
    if dev.type == "cuda":
        from ..profiling import device_ms
        rec["device_ms"] = device_ms(run, 1) / args.iters
    line = json.dumps(rec)
    print(line, flush=True)
    if args.json:
        with open(args.json, "a") as f:
            f.write(line + "\n")

    if args.profile:
        from ..profiling import (device_summary, print_summary,
                                 summarize_trace, trace_fn)
        trace = trace_fn(run, iters=1, warmup=0, device=dev)
        rows_t = summarize_trace(trace._replace(iters=args.iters),
                                 device_only=dev.type == "cuda")
        print_summary(rows_t, top=28)
        # The program's counters a step; the scan's yield is the share of
        # its (row, tile) slots that survive the cull.
        ctrs = {k: v / args.iters for k, v in trace.counters.items()}
        rec["profile"] = {"top": rows_t[:28], "counters": ctrs}
        if ctrs.get("binning.slots"):
            rec["profile"]["scan_yield"] = (100.0 * ctrs["binning.kept"]
                                            / ctrs["binning.slots"])
        print("counters a step: " + "  ".join(
            f"{k} {v:g}" for k, v in ctrs.items()))
        if "scan_yield" in rec["profile"]:
            print(f"scan_yield {rec['profile']['scan_yield']:.4f}%")
        if dev.type == "cuda":
            rec["profile"].update(device_summary(trace))
    return {**rec, "stats": s, "grads": last["grads"]}


if __name__ == "__main__":
    main()
