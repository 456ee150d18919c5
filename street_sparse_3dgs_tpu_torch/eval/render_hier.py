"""Hierarchy evaluation driver — the ``render_hierarchy.py`` /
``render_hierarchy_final.py`` equivalents, mirroring
``street_sparse_3dgs_tpu/eval/render_hier.py``.

Renders the test (or train) set from a merged hierarchy at the τ sweep
(default 0/3/6/15 px, reference ``render_hierarchy.py:168``), computing
PSNR/SSIM/LPIPS + iMAE/iRMSE against alpha-masked ground truth and LiDAR
inverse depth, with optional per-category and depth-stratified breakdowns
(``render_hierarchy_final.py``).  Everything runs on the hierarchy's
device; renders are written as PNGs through ``data/png.py``.
"""

from __future__ import annotations

from pathlib import Path

import torch

from ..config import ModelConfig, PipelineConfig
from ..data import png
from ..data.scene import CameraStream, load_scene_info
from ..hierarchy.render import render_cut, render_cut_compact
from ..hierarchy.structure import Hierarchy, pixel_limit, select_cut
from ..train import losses
from ..train.step import raster_config
from . import lpips as _lpips
from . import metrics

DEFAULT_TAUS = (0.0, 3.0, 6.0, 15.0)


def to_uint8(image: torch.Tensor):
    """[3, H, W] in [0, 1] -> [H, W, 3] uint8 numpy (truncating, as the JAX
    package's ``(x * 255).astype(np.uint8)``)."""
    return (image.permute(1, 2, 0) * 255).to(torch.uint8).cpu().numpy()


def render_hierarchy_eval(
    h: Hierarchy,
    scene_source: str,
    model_cfg: ModelConfig | None = None,
    pipe: PipelineConfig | None = None,
    taus=DEFAULT_TAUS,
    out_dir: str | Path | None = None,
    on_train: bool = False,
    with_lpips: bool = True,
    with_breakdowns: bool = False,
    sh_degree: int = 3,
    compact: bool = True,
    seg_dir: str | Path | None = None,
) -> dict:
    """Returns {tau: {psnr, ssim, lpips, imae, irmse, ...}} averaged over the
    evaluated views; optionally writes renders to ``out_dir/renders_tau``.

    ``seg_dir``: directory of color-coded segmentation masks (one per image
    name) enabling the per-semantic-category breakdown
    (``render_hierarchy_final.py`` CATEGORY_GROUPS)."""
    losses.tf32_off()
    dev = h.params.xyz.device
    model_cfg = model_cfg or ModelConfig(eval=True)
    pipe = pipe or PipelineConfig()
    cfg = raster_config(pipe)
    bg = torch.zeros(3, device=dev)
    info = load_scene_info(scene_source, model_cfg)
    cams = info.train_cameras if on_train else info.test_cameras
    cams = [c for c in cams if not c.is_depth_only]
    stream = CameraStream(cams, resolution=model_cfg.resolution,
                          shuffle=False, device=dev)

    results = {}
    try:
        for tau in taus:
            rows, weights = [], []
            band_rows = {name: [] for name, *_ in metrics.DEPTH_RANGES}
            band_weights = {name: [] for name, *_ in metrics.DEPTH_RANGES}
            cat_rows = {name: [] for name in metrics.CATEGORY_GROUPS}
            cat_weights = {name: [] for name in metrics.CATEGORY_GROUPS}
            for batch, caminfo in zip(stream, cams):
                cam = batch.camera
                limit = pixel_limit(tau, float(cam.tan_fovx), cam.width)
                cut = select_cut(h, cam.campos, limit)
                with torch.no_grad():
                    if compact:
                        out = render_cut_compact(h.params, cut, h.n_nodes,
                                                 h.skybox_count, cam,
                                                 sh_degree, bg, cfg)
                    else:
                        out = render_cut(h.params, cut, h.n_nodes,
                                         h.skybox_count, cam, sh_degree, bg,
                                         cfg)
                image = torch.clamp(out["render"], 0, 1)
                invdepth = out["depth"]
                gt = batch.gt_image
                mask = batch.alpha_mask
                has_depth = bool(batch.depth_reliable)
                row = metrics.full_metrics(
                    image, gt, mask,
                    pred_invdepth=invdepth if has_depth else None,
                    gt_invdepth=batch.mono_invdepth if has_depth else None,
                    with_lpips=with_lpips)
                rows.append(row)
                weights.append(float(mask.sum()))

                if with_breakdowns and has_depth:
                    bands = metrics.depth_band_masks(batch.mono_invdepth,
                                                     mask)
                    for name, bmask in bands.items():
                        if bmask.sum() < 16:
                            continue
                        band_rows[name].append({
                            "psnr": metrics.psnr_masked(image, gt, bmask),
                            "ssim": metrics.ssim_masked(image, gt, bmask)})
                        band_weights[name].append(float(bmask.sum()))

                stem = caminfo.image_name.rsplit(".", 1)[0]
                if seg_dir is not None:
                    seg_path = Path(seg_dir) / f"{stem}.png"
                    if seg_path.exists():
                        seg = png.resize_bicubic(
                            png.to_rgb(png.read_image(seg_path)),
                            (image.shape[2], image.shape[1]))
                        seg = torch.as_tensor(seg, device=dev).permute(
                            2, 0, 1).to(torch.float32) / 255.0
                        cats = metrics.category_masks(
                            seg, metrics.CATEGORY_GROUPS)
                        for name, cmask in cats.items():
                            cmask = cmask * (mask > 0)
                            if cmask.sum() < 16:
                                continue
                            cat_rows[name].append({
                                "psnr": metrics.psnr_masked(image, gt, cmask),
                                "ssim": metrics.ssim_masked(image, gt,
                                                            cmask)})
                            cat_weights[name].append(float(cmask.sum()))

                if out_dir is not None:
                    rdir = Path(out_dir) / f"renders_tau{tau:g}"
                    rdir.mkdir(parents=True, exist_ok=True)
                    png.write_png(rdir / f"{stem}.png", to_uint8(image))

            agg = metrics.aggregate_pixel_weighted(rows, weights) \
                if rows else {}
            if with_lpips:
                # Provenance is part of the result: the fallback uses
                # deterministic RANDOM features, which must be impossible to
                # mistake for real (calibrated) LPIPS.
                agg["lpips_weights"] = _lpips.weights_kind()
            if with_breakdowns:
                agg["bands"] = {
                    name: metrics.aggregate_pixel_weighted(
                        band_rows[name], band_weights[name])
                    for name in band_rows if band_rows[name]}
            if seg_dir is not None:
                agg["categories"] = {
                    name: metrics.aggregate_pixel_weighted(
                        cat_rows[name], cat_weights[name])
                    for name in cat_rows if cat_rows[name]}
            results[tau] = agg
            msg = " ".join(f"{k.upper()}: {v:.5f}" for k, v in agg.items()
                           if isinstance(v, float))
            if "lpips_weights" in agg:
                msg += f" LPIPS_WEIGHTS: {agg['lpips_weights']}"
            print(f"tau: {tau:g}, {msg}")
    finally:
        stream.close()
    return results
