"""Fork-features end-to-end A/B on the card, the port's counterpart of
``tools/fork_features_tpu.py``.

The reference fork exists for LiDAR chunk init + mono-depth supervision +
depth-only virtual cameras + alpha masks + GT-cloud pruning composing in
one training run.  This drives the all-features synthetic project
(``tools/synth_project``'s fork knobs) through the 5-stage pipeline twice:

  arm ON  -- LiDAR-augmented chunk init, depth L1 (decayed) on every view,
             depth-only virtual cameras, alpha masks over the per-view
             "moving object" corruption, GT-cloud constraint pruning;
  arm OFF -- the same scene and corrupted images, SfM-only init, none of the
             features (what vanilla hierarchical 3DGS would see).

Both arms are evaluated on the CLEAN held-out view with oracle-true depth
(iMAE/iRMSE).  Results land in ``<dir>/<arm>/results.json`` and
``--report`` prints the A/B table.  Each arm resumes
(``full_train(skip_if_exists=True)``)::

    python -m street_sparse_3dgs_tpu_torch.tools.fork_features --arm on
    python -m street_sparse_3dgs_tpu_torch.tools.fork_features --arm off
    python -m street_sparse_3dgs_tpu_torch.tools.fork_features --report

On the card the raster config is the exact kernels (K 384, ``max_dup`` 64,
``exact_extra`` 128, bf16 grad sort: K5, K3, K4); with ``--device cpu``
the tiled K 512, as the JAX tool's CPU validation.  ``main`` returns the
arm's results (or the report's rows).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from ..config import ModelConfig, OptimizationConfig, PipelineConfig
from ..device import resolve_device
from ..eval.render_hier import render_hierarchy_eval
from ..hierarchy.io import load_hierarchy
from ..pipeline import full_train as ft
from .synth_project import make_project

DEPTHS = dict(coarse_iterations=200, chunk_iterations=800,
              post_iterations=300)
SKYBOX = 500
PROJECT = dict(n_views=16, with_depths=True, depth_cams=6, with_masks=True,
               with_gt_cloud=True, sfm_keep=0.3, sfm_noise=0.05)


def build_project(root: Path, arm: str, scale: float, dev):
    d = root / arm
    if (d / "camera_calibration").exists():
        print(f"reusing {arm} project", d, flush=True)
        return ft.ProjectPaths(d)
    d.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    # Degraded SfM: the LiDAR augmentation has signal to recover.
    proj = make_project(d, n=int(400 * scale), lidar=(arm == "on"),
                        device=dev, **PROJECT)
    print(f"{arm} project built in {time.time() - t0:.0f}s", flush=True)
    return proj


def arm_model_cfg(arm: str) -> ModelConfig:
    if arm == "on":
        return ModelConfig(eval=True, resolution=1,
                           additional_depth_maps=True,
                           gt_point_cloud_constraints=True,
                           constraint_treshold=0.15)
    # OFF: depth/mask dirs point at names that do not exist, so that the
    # auto-enable of full_train._model_cfg_for stays off.
    return ModelConfig(eval=True, resolution=1, depths="no_depths",
                       alpha_masks="no_masks")


def pipe_config(dev) -> PipelineConfig:
    if dev.type == "cpu":
        return PipelineConfig(raster_method="tiled", tile_capacity=512)
    return PipelineConfig(raster_method="pallas", tile_capacity=384,
                          max_dup=64, exact_extra=128, grad_sort="bf16")


def run_arm(root: Path, arm: str, scale: float, dev) -> dict | None:
    proj = build_project(root, arm, scale, dev)
    opt = OptimizationConfig(
        iterations=800, densification_interval=100, densify_from_iter=200,
        densify_until_iter=600, opacity_reset_interval=10_000,
        position_lr_init=2e-4, position_lr_final=2e-6,
        densify_grad_threshold=2e-4)
    pipe = pipe_config(dev)
    t0 = time.time()
    merged = ft.full_train(proj.project_dir, arm_model_cfg(arm), opt, pipe,
                           skip_if_exists=True, skybox_num=SKYBOX,
                           device=dev, **DEPTHS)
    print(f"full_train returned in {time.time() - t0:.0f}s", flush=True)
    if merged is None:
        print("arm not finished yet -- rerun this command", flush=True)
        return None

    # Depth GT in BOTH arms (clean held-out view, oracle depth).
    mc = ModelConfig(eval=True, resolution=1, images=str(proj.images_dir),
                     depths=str(proj.depths_dir))
    h = load_hierarchy(proj.output_dir / "merged.hier.npz", device=dev)
    res = {}
    for split, on_train in (("test", False), ("train", True)):
        r = render_hierarchy_eval(h, str(proj.colmap_dir), mc, pipe,
                                  taus=(0.0,), with_lpips=False,
                                  on_train=on_train)
        res[split] = {k: v for k, v in r[0.0].items()
                      if isinstance(v, float)}
    res["n_nodes"] = int(h.n_nodes)
    (root / arm / "results.json").write_text(json.dumps(res, indent=2))
    print(json.dumps(res, indent=2), flush=True)
    return res


def report(root: Path) -> dict:
    rows = {}
    for arm in ("off", "on"):
        p = root / arm / "results.json"
        if not p.exists():
            print(f"arm {arm}: no results yet")
            continue
        rows[arm] = json.loads(p.read_text())
    if len(rows) == 2:
        print(f"{'metric':10s} {'OFF':>10s} {'ON':>10s}   (held-out tau0)")
        for k in ("psnr", "ssim", "imae", "irmse"):
            a = rows["off"]["test"].get(k)
            b = rows["on"]["test"].get(k)
            if a is None or b is None:
                continue
            print(f"{k:10s} {a:10.4f} {b:10.4f}")
        print(f"{'train psnr':10s} {rows['off']['train']['psnr']:10.4f} "
              f"{rows['on']['train']['psnr']:10.4f}")
    return rows


def main(argv=None) -> dict | None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default="build/fork_features")
    ap.add_argument("--arm", choices=["on", "off"])
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # Absolute, as tools/pipeline_quality's project dir.
    root = Path(args.dir).resolve()
    if args.report:
        return report(root)
    if not args.arm:
        raise SystemExit("pass --arm on|off or --report")
    dev = resolve_device(args.device)
    print("device:", dev, flush=True)
    return run_arm(root, args.arm, args.scale, dev)


if __name__ == "__main__":
    main()
