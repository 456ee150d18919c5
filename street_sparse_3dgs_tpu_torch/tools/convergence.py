"""Convergence comparison: train the toy scene through one raster method or
several side by side and report held-in PSNR, the port's counterpart of
``tools/convergence_tpu.py``.

The configs are identical across methods (same binning caps, same seeds,
same init), so a PSNR gap isolates the blend: ``tiled`` is the plain
PyTorch blend, ``pallas`` the padded kernels (K5, K1, K2), ``pallas-exact``
the production exact path (K5, K3, K4; K 128, ``exact_extra`` 1024, the
counts backward, bf16 grad sort).  Eval renders use the training method::

    python -m street_sparse_3dgs_tpu_torch.tools.convergence pallas
    python -m street_sparse_3dgs_tpu_torch.tools.convergence \\
        --methods tiled,pallas,pallas-exact [ITERS [SEED]] [--device cpu]

The GT is the oracle at 192x192 average-pooled to 96x96 (the production
path never sees its own output as a target).  The init is the scene points
plus 0.03 N(0, 1) jitter at capacity 2048: the jitter comes from
``--jitter-from`` (an ``.npy`` of [400, 3], e.g. JAX's
``jax.random.normal(PRNGKey(0))`` draw) or a ``torch.Generator`` seeded 0.
``main`` returns one record per method.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from ..config import ModelConfig, OptimizationConfig, PipelineConfig
from ..data.toy import lookat_camera, make_toy_scene
from ..device import resolve_device
from ..models.gaussians import (activate_opacity, activate_scales,
                                create_from_pcd, sh_coeffs)
from ..ops.rasterize import RasterConfig, rasterize
from ..train import losses
from ..train.loop import train_loop
from ..train.step import CameraBatch, init_state

RES = 96
METHODS = ("tiled", "pallas", "pallas-exact")


def oracle_gt_2x(rows, cam_hi) -> torch.Tensor:
    """The oracle render at ``cam_hi`` clipped to [0, 1] and 2x2
    average-pooled."""
    with torch.no_grad():
        out = rasterize(*rows, cam_hi, 3,
                        torch.zeros(3, device=rows[0].device),
                        RasterConfig(method="oracle"))
    img = torch.clamp(out["render"], 0.0, 1.0)
    c, h, w = img.shape
    return img.reshape(c, h // 2, 2, w // 2, 2).mean(dim=(2, 4))


def gt_images(rows, dev) -> list:
    """The six views' GT: cameras on a circle of radius 3 at 2x."""
    gts = []
    for i in range(6):
        ang = 2.0 * math.pi * i / 6
        pos = np.array([3.0 * math.cos(ang), 3.0 * math.sin(ang), 0.8])
        gts.append(oracle_gt_2x(rows, lookat_camera(
            pos, np.zeros(3), RES * 2, RES * 2, device=dev)))
    return gts


def init_model(means, sh, jitter):
    """(params, active, meta) from the jittered scene points and their DC
    colours at capacity 2048."""
    pts = means + 0.03 * jitter
    cols = torch.clamp(sh[:, 0, :] * 0.28 + 0.5, 0, 1)
    return create_from_pcd(pts, cols, sh_degree=3, capacity=2048)


def configs(method: str) -> tuple:
    """(training PipelineConfig, eval RasterConfig) of a method."""
    if method == "pallas-exact":
        return (PipelineConfig(raster_method="pallas", tile_capacity=128,
                               exact_extra=1024, grad_reduce="counts",
                               grad_sort="bf16"),
                RasterConfig(method="pallas", tile_capacity=128, max_dup=64,
                             exact_extra=1024))
    return (PipelineConfig(tile_capacity=1024, raster_method=method),
            RasterConfig(method=method, tile_capacity=1024, max_dup=64))


def train_method(method: str, scene, gts, jitter, iters: int, seed: int,
                 dev) -> dict:
    """Train one method from the shared init and evaluate it on the
    training views."""
    params, active, meta = init_model(scene.means3d, scene.sh_coeffs, jitter)
    batches = [CameraBatch(
        camera=cam, gt_image=gt,
        alpha_mask=torch.ones((1, RES, RES), device=dev),
        mono_invdepth=torch.zeros((1, RES, RES), device=dev),
        depth_mask=torch.zeros((1, RES, RES), device=dev),
        depth_reliable=torch.tensor(False, device=dev),
        image_index=torch.tensor(i, device=dev))
        for i, (cam, gt) in enumerate(zip(scene.cameras, gts))]
    opt = OptimizationConfig(
        iterations=iters, densification_interval=100, densify_from_iter=300,
        densify_until_iter=1200, opacity_reset_interval=10_000,
        densify_grad_threshold=2e-4)
    pipe, cfg = configs(method)
    state = init_state(params, active, n_images=len(gts))
    t0 = time.time()
    state, meta, stats = train_loop(
        state, meta, batches, opt, pipe, ModelConfig(),
        cameras_extent=3.0, spatial_lr_scale=1.0, clamp_fraction=1.0,
        rng_seed=seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0

    vals = []
    with torch.no_grad():
        for cam, gt in zip(scene.cameras, gts):
            out = rasterize(state.params.xyz, activate_scales(state.params),
                            state.params.quats,
                            activate_opacity(state.params, meta),
                            sh_coeffs(state.params), cam, 3,
                            torch.zeros(3, device=dev), cfg,
                            active_mask=state.active)
            vals.append(float(losses.psnr(torch.clamp(out["render"], 0, 1),
                                          gt)))
    n_active = int(state.active.sum())
    print(f"method={method} iters={iters} seed={seed} wall={wall:.0f}s "
          f"PSNR={np.mean(vals):.2f} (per-view {['%.1f' % v for v in vals]}) "
          f"n_active={n_active}", flush=True)
    return {"method": method, "iters": iters, "seed": seed, "wall_s": wall,
            "psnr": float(np.mean(vals)), "per_view": vals,
            "n_active": n_active, "losses": stats["losses"],
            "skipped_updates": stats["skipped_updates"],
            "tile_overflow": stats["tile_overflow"],
            "dup_overflow": stats["dup_overflow"]}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("positional", nargs="*", metavar="METHOD ITERS SEED",
                    help="the JAX tool's arguments: method (default "
                         "pallas; left out with --methods), iterations "
                         "(1500) and seed (5)")
    ap.add_argument("--methods", default="",
                    help="comma-separated methods run side by side in one "
                         "process on identical inputs")
    ap.add_argument("--jitter-from", default="",
                    help=".npy of the [400, 3] init jitter")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    pos = list(args.positional)
    methods = args.methods.split(",") if args.methods else \
        [pos.pop(0) if pos else "pallas"]
    iters = int(pos.pop(0)) if pos else 1500
    seed = int(pos.pop(0)) if pos else 5
    if pos:
        raise SystemExit(f"unexpected arguments {pos}")
    for m in methods:
        if m not in METHODS:
            raise SystemExit(f"unknown method {m!r}; one of {METHODS}")
    dev = resolve_device(args.device)

    scene = make_toy_scene(seed=11, n=400, n_cameras=6, width=RES,
                           height=RES, device=dev)
    rows = (scene.means3d, scene.scales, scene.quats, scene.opacities,
            scene.sh_coeffs)
    gts = gt_images(rows, dev)
    if args.jitter_from:
        jitter = torch.as_tensor(np.load(args.jitter_from),
                                 dtype=torch.float32, device=dev)
    else:
        jitter = torch.randn(scene.means3d.shape,
                             generator=torch.Generator().manual_seed(0)).to(dev)
    return [train_method(m, scene, gts, jitter, iters, seed, dev)
            for m in methods]


if __name__ == "__main__":
    main()
