"""Per-stage quality of the 5-stage pipeline on the synthetic 2-chunk
project, the port's counterpart of ``tools/pipeline_quality_tpu.py`` and
``tools/pipeline_quality.py`` in one tool.

Builds ``tools/synth_project``'s project (oracle-rendered 2x-supersampled
GT, one held-out view, skybox on), drives it through coarse -> per-chunk
training -> hierarchy -> post-opt -> merge (``pipeline.full_train`` at 200
coarse, 800 chunk and 300 post steps, a 500-row skybox), then prints the
train-view and held-out PSNR after each stage: per chunk its ``hier`` and
``hier_opt`` trees at tau 0, then the merged tree's held-out sweep at tau
0/3/6/15 with LPIPS and its train tau 0::

    python -m street_sparse_3dgs_tpu_torch.tools.pipeline_quality \\
        [--dir build/pipe_quality] [--config pallas|cpu] [--exact]
        [--large] [--fresh] [--device cpu]

``--config pallas`` (default) is ``pipeline_quality_tpu.py``'s kernel config
(padded K 384, ``max_dup`` 64: K5, K1, K2; ``--exact`` adds
``exact_extra`` 128: K5, K3, K4); ``--config cpu`` is
``pipeline_quality.py``'s tiled K 512.  ``--large`` is the larger flavour:
1,200 Gaussians, 24 views (2 held out), 192x144, the exact counts config
(K 128, ``exact_extra`` 512).  The project directory persists and the
stages resume (``full_train(skip_if_exists=True)``): rerun the command to
finish a cut run.  ``main`` returns the tables.
"""

from __future__ import annotations

import argparse
import shutil
import time
from pathlib import Path

from ..config import ModelConfig, OptimizationConfig, PipelineConfig
from ..device import resolve_device
from ..eval.render_hier import render_hierarchy_eval
from ..hierarchy.io import load_hierarchy
from ..pipeline import full_train as ft
from .synth_project import make_project

TAUS = (0.0, 3.0, 6.0, 15.0)
DEPTHS = dict(coarse_iterations=200, chunk_iterations=800,
              post_iterations=300)
SKYBOX = 500
LARGE = dict(n=1200, n_views=24, width=192, height=144, held_out=2)


def opt_config() -> OptimizationConfig:
    return OptimizationConfig(
        iterations=800, densification_interval=100, densify_from_iter=200,
        densify_until_iter=600, opacity_reset_interval=10_000,
        position_lr_init=2e-4, position_lr_final=2e-6,
        densify_grad_threshold=2e-4)


def pipe_config(config: str, exact: bool, large: bool,
                grad_sort: str) -> PipelineConfig:
    if config == "cpu":
        return PipelineConfig(tile_capacity=512)
    if large:
        return PipelineConfig(raster_method="pallas", tile_capacity=128,
                              max_dup=64, exact_extra=512,
                              grad_sort=grad_sort, grad_reduce="counts")
    return PipelineConfig(raster_method="pallas", tile_capacity=384,
                          max_dup=64, exact_extra=128 if exact else 0,
                          grad_sort=grad_sort)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default="build/pipe_quality")
    ap.add_argument("--config", default="pallas", choices=["pallas", "cpu"])
    ap.add_argument("--exact", action="store_true",
                    help="exact virtual-tile mode (exact_extra=128)")
    ap.add_argument("--grad-sort", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--fresh", action="store_true",
                    help="wipe the project dir first")
    ap.add_argument("--large", action="store_true",
                    help="larger flavor: 1200 gaussians, 24 views (2 held "
                         "out), 192x144, exact production raster config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print("device:", dev, flush=True)

    # Absolute: the scene loader joins the image, depth and mask dirs to
    # the source path, and a relative dir there finds no file (every GT
    # image would load black).
    tmp = Path(args.dir).resolve()
    if args.fresh:
        shutil.rmtree(tmp, ignore_errors=True)
    if (tmp / "camera_calibration").exists():
        proj = ft.ProjectPaths(tmp)
        print("reusing project", tmp, flush=True)
    else:
        tmp.mkdir(parents=True, exist_ok=True)
        t0 = time.time()
        proj = make_project(tmp, **(LARGE if args.large else {}), device=dev)
        print(f"project built in {time.time() - t0:.0f}s", flush=True)

    pipe = pipe_config(args.config, args.exact, args.large, args.grad_sort)
    model = ModelConfig(eval=True, resolution=1)
    t0 = time.time()
    merged = ft.full_train(proj.project_dir, model, opt_config(), pipe,
                           skip_if_exists=True, skybox_num=SKYBOX,
                           device=dev, **DEPTHS)
    train_s = time.time() - t0
    print(f"full_train returned in {train_s:.0f}s", flush=True)
    if merged is None:
        raise RuntimeError("full_train returned no merged hierarchy")

    mc = ModelConfig(eval=True, resolution=1, images=str(proj.images_dir))
    per_chunk = {}
    for name in ("0_0", "1_0"):
        for hier in ("hierarchy.hier.npz", "hierarchy.hier_opt.npz"):
            p = proj.trained_chunks_dir / name / hier
            if not p.exists():
                continue
            h = load_hierarchy(p, device=dev)
            src = str(proj.chunks_dir / name)
            r_test, r_train = (render_hierarchy_eval(
                h, src, mc, pipe, taus=(0.0,), with_lpips=False,
                on_train=on_train) for on_train in (False, True))
            per_chunk[f"{name}/{hier}"] = {"test": r_test[0.0],
                                           "train": r_train[0.0]}
            print(f"{name}/{hier}: held-out tau0 "
                  f"{r_test[0.0]['psnr']:.2f}  train tau0 "
                  f"{r_train[0.0]['psnr']:.2f}", flush=True)

    h = load_hierarchy(proj.output_dir / "merged.hier.npz", device=dev)
    t0 = time.time()
    r_test = render_hierarchy_eval(h, str(proj.colmap_dir), mc, pipe,
                                   taus=TAUS, with_lpips=True)
    print(f"held-out sweep in {time.time() - t0:.0f}s", flush=True)
    t0 = time.time()
    r_train = render_hierarchy_eval(h, str(proj.colmap_dir), mc, pipe,
                                    taus=(0.0,), with_lpips=False,
                                    on_train=True)
    print(f"merged train tau0 PSNR {r_train[0.0]['psnr']:.2f} "
          f"({time.time() - t0:.0f}s)", flush=True)
    for t in TAUS:
        r = r_test[t]
        print(f"merged held-out tau{t:g}: PSNR {r['psnr']:.2f} "
              f"SSIM {r['ssim']:.3f} LPIPS {r['lpips']:.3f} "
              f"({r.get('lpips_weights', '?')})", flush=True)
    print(f"merged: held-out tau0 {r_test[0.0]['psnr']:.2f}  "
          f"train tau0 {r_train[0.0]['psnr']:.2f}", flush=True)
    return {"project": str(proj.project_dir), "train_s": train_s,
            "per_chunk": per_chunk, "merged_test": r_test,
            "merged_train": r_train[0.0], "n_nodes": int(h.n_nodes)}


if __name__ == "__main__":
    main()
