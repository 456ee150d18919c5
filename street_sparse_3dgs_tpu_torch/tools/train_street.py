"""Resumable street-scale training on the card, the counterpart of
``tools/train_street_tpu.py``.

GT images of the synthetic street scene are rendered once through the
exact path with self-sized knobs (``ops/autosize.py``; ``tile_overflow`` is
asserted 0 per view, so no contribution is dropped).  The trainee starts
from a 100k-point subsample of the scene points at capacity 262,144 and
trains in slices of ``--slice`` iterations through the exact path with the
counts backward and the self-sized emission and window knobs
(``exact_extra=-1``), densifying toward 1M+ rows: capacity growth, budget
growth and the overflow guard all run under real drift.  Each invocation
trains while ``--wall`` seconds allow another slice, appends a line per
slice to ``log.jsonl``, checkpoints to ``ckpt.npz`` and resumes from it on
the next invocation; once ``--iters`` is reached it reports the training
PSNR over the first four views::

    python -m street_sparse_3dgs_tpu_torch.tools.train_street   # repeat
    python -m street_sparse_3dgs_tpu_torch.tools.train_street --status

``main`` returns the final state, meta, resolved config, optimiser config,
iteration, log records, PSNRs and batches, for a caller that drives it
in-process.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..config import ModelConfig, OptimizationConfig, PipelineConfig
from ..data.toy import make_street_scene
from ..device import resolve_device
from ..models.gaussians import (activate_opacity, activate_scales,
                                create_from_pcd, sh_coeffs)
from ..models.serialize import load_checkpoint, save_checkpoint
from ..ops import autosize
from ..ops.rasterize import RasterConfig, rasterize
from ..train.loop import autosize_pipeline, train_loop
from ..train.step import CameraBatch, init_state, raster_config

W, H = 960, 544
N_INIT = 100_000            # trainee start: a subsample of the scene points
CAPACITY = 262_144


def build_gt(root: Path, n: int, views: int, device: torch.device,
             seed: int = 0):
    """Render the GT images once through the autosized exact path and pick
    the init points (a seeded subsample of the scene points, jittered);
    both go to ``root/gt.npz``.  Returns (cameras, GT images [V, 3, H, W]
    float16, points, colours)."""
    scene = make_street_scene(seed=seed, n=n, n_cameras=views, width=W,
                              height=H, device=device)
    rows = (scene.means3d, scene.scales, scene.quats, scene.opacities,
            scene.sh_coeffs)
    knobs = autosize.autosize_raster(*rows, list(scene.cameras), 3, H, W, 128,
                            max_dup=0)
    print("gt autosize:", knobs, flush=True)
    cfg = RasterConfig(method="pallas", tile_capacity=128,
                       max_dup=knobs.max_dup,
                       dup_overscan=knobs.dup_overscan,
                       dup_tails=knobs.dup_tails,
                       exact_extra=knobs.exact_extra)
    gts = []
    with torch.no_grad():
        for i, cam in enumerate(scene.cameras):
            t0 = time.time()
            out = rasterize(*rows, cam, 3, torch.zeros(3, device=device),
                            cfg)
            img = torch.clamp(out["render"], 0, 1).cpu().numpy().astype(
                np.float16)
            if int(out["tile_overflow"]) != 0:
                raise AssertionError(f"gt view {i}: tile_overflow "
                                     f"{int(out['tile_overflow'])}")
            print(f"gt view {i}: {time.time() - t0:.1f}s "
                  f"dup_of={int(out['dup_overflow'])}", flush=True)
            gts.append(img)
    rng = np.random.default_rng(1)
    n_init = min(N_INIT, n)
    sel = rng.choice(n, size=n_init, replace=False)
    means = scene.means3d.cpu().numpy()
    pts = means[sel] + 0.02 * rng.normal(size=(n_init, 3))
    cols = np.clip(scene.sh_coeffs[:, 0].cpu().numpy()[sel] * 0.28 + 0.5,
                   0, 1)
    np.savez_compressed(
        root / "gt.npz", gts=np.stack(gts), pts=pts, cols=cols,
        viewmats=np.stack([c.viewmatrix.cpu().numpy()
                           for c in scene.cameras]))
    return scene.cameras, gts, pts, cols


def camera_batches(cameras, gts, device: torch.device) -> list:
    """One ``CameraBatch`` per view: its GT image in f32, no mask, no depth
    supervision."""
    shape = (1, H, W)
    return [CameraBatch(
        camera=cam, gt_image=torch.as_tensor(gts[i], device=device).float(),
        alpha_mask=torch.ones(shape, device=device),
        mono_invdepth=torch.zeros(shape, device=device),
        depth_mask=torch.zeros(shape, device=device),
        depth_reliable=torch.tensor(False, device=device),
        image_index=torch.tensor(i, device=device))
        for i, cam in enumerate(cameras)]


def train_psnr(state, meta, pipe, batches) -> list[float]:
    """Training PSNR of each view of ``batches`` through the exact path."""
    cfg = raster_config(pipe)
    psnrs = []
    with torch.no_grad():
        for b in batches:
            out = rasterize(state.params.xyz, activate_scales(state.params),
                            state.params.quats,
                            activate_opacity(state.params, meta),
                            sh_coeffs(state.params), b.camera, 3,
                            torch.zeros(3, device=b.gt_image.device), cfg,
                            active_mask=state.active)
            img = torch.clamp(out["render"], 0, 1)
            mse = float(torch.mean((img - b.gt_image) ** 2))
            psnrs.append(-10 * float(np.log10(mse)))
    return psnrs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default="build/train_street")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--views", type=int, default=12)
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--wall", type=float, default=540.0,
                    help="whole-invocation budget (s): a new slice starts "
                         "only if the last slice's wall and the checkpoint "
                         "write still fit")
    # Slice >= 2x densification_interval: the loop's cadence counter is
    # local to a slice, so densify fires at local iterations 100 and 200.
    ap.add_argument("--slice", type=int, default=200)
    ap.add_argument("--status", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = Path(args.dir)
    root.mkdir(parents=True, exist_ok=True)
    log = root / "log.jsonl"

    if args.status:
        for ln in log.read_text().splitlines()[-10:]:
            print(ln)
        return {}

    t_start = time.time()      # whole-invocation budget (GT build included)
    dev = resolve_device(args.device)
    # Cameras regenerate deterministically from the seed and n; GT loads
    # from disk.
    if not (root / "gt.npz").exists():
        build_gt(root, args.n, args.views, dev)
    scene = make_street_scene(seed=0, n=args.n, n_cameras=args.views,
                              width=W, height=H, device=dev)
    z = np.load(root / "gt.npz")
    gts, pts, cols = z["gts"], z["pts"], z["cols"]
    batches = camera_batches(scene.cameras, gts, dev)
    del scene

    ckpt = root / "ckpt.npz"
    if ckpt.exists():
        state, meta, start_it = load_checkpoint(ckpt, dev)
        print(f"resumed at iter {start_it}, capacity {meta.capacity}, "
              f"active {int(state.active.sum())}", flush=True)
    else:
        params, active, meta = create_from_pcd(
            torch.as_tensor(pts, dtype=torch.float32, device=dev),
            torch.as_tensor(cols, dtype=torch.float32, device=dev),
            sh_degree=3, capacity=CAPACITY)
        state = init_state(params, active, n_images=args.views)
        start_it = 0

    # densify_from_iter = 0: train_loop's cadence counter is LOCAL to each
    # slice, so the global warm-up is expressed via densify_enabled below.
    opt = OptimizationConfig(
        iterations=args.iters, densification_interval=100,
        densify_from_iter=0, densify_until_iter=10**9,
        opacity_reset_interval=10**9, position_lr_init=1.6e-5,
        position_lr_final=1.6e-7, densify_grad_threshold=2e-5,
        percent_dense=0.0001)
    densify_until = int(args.iters * 0.85)
    pipe = PipelineConfig(raster_method="pallas", tile_capacity=128,
                          exact_extra=-1, grad_reduce="counts",
                          grad_sort="bf16")
    model_cfg = ModelConfig()

    it = start_it
    extent = 60.0
    last_slice = 120.0        # first-slice estimate
    records = []
    while it < args.iters and (time.time() - t_start + 1.3 * last_slice
                               + 45.0 < args.wall):
        n_slice = min(args.slice, args.iters - it)
        t0 = time.time()
        state, meta, stats = train_loop(
            state, meta, batches, opt, pipe, model_cfg,
            cameras_extent=extent, spatial_lr_scale=extent,
            iterations=n_slice,
            densify_enabled=(100 <= it < densify_until),
            rng_seed=it)
        # train_loop counts its own iterations; the global position is
        # carried here (state.step keeps the optimizer's step count).
        pipe = stats["final_pipe"]          # autosized/grown knobs persist
        it += n_slice
        wall = time.time() - t0
        last_slice = wall
        rec = dict(it=it, wall_per_iter=round(wall / n_slice, 4),
                   n_active=int(state.active.sum()),
                   capacity=int(meta.capacity),
                   max_dup=int(pipe.max_dup),
                   dup_overscan=int(pipe.dup_overscan),
                   dup_tails=[list(t) for t in pipe.dup_tails],
                   exact_extra=int(pipe.exact_extra),
                   growths=stats["exact_growths"],
                   cap_growths=stats["overflows"],
                   skipped=stats["skipped_updates"],
                   tile_of=stats["tile_overflow"],
                   dup_of=stats["dup_overflow"],
                   loss_first=round(float(np.mean(stats["losses"][:10])),
                                    5),
                   loss=round(float(np.mean(stats["losses"][-10:])), 5))
        records.append(rec)
        with log.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)

    save_checkpoint(ckpt, state, meta, it)
    print(f"checkpointed at iter {it} "
          f"({time.time() - t_start:.0f}s this window)", flush=True)

    psnrs = None
    if it >= args.iters:
        if pipe.exact_extra < 0:
            # Re-invocation after completion: no slice ran, so the -1
            # sentinel was never resolved: autosize for the render.
            pipe = autosize_pipeline(pipe, state, meta, batches)
        psnrs = train_psnr(state, meta, pipe, batches[:4])
        print(f"FINAL: iters={it} n_active={int(state.active.sum())} "
              f"train PSNR ({len(psnrs)} views) = {np.mean(psnrs):.2f} "
              f"{['%.1f' % p for p in psnrs]}", flush=True)
    return {"state": state, "meta": meta, "pipe": pipe, "opt": opt,
            "it": it, "records": records, "psnrs": psnrs,
            "batches": batches}


if __name__ == "__main__":
    main()
