"""A synthetic 2-chunk street-like project on disk, the port's counterpart
of ``tests/test_pipeline.py::make_project`` (the fixture the JAX package's
``pipeline_quality`` and ``fork_features`` tools build on).

A plane of Gaussians along x, cameras orbiting above; the GT images are
rendered by the oracle at 2x and average-pooled, so the production
projection, binning and blend never see their own output as a target.
Every knob and artifact is the JAX function's: the COLMAP model and
``test.txt``, the fork's 16-bit inverse-depth PNGs and ``depth_params.json``,
the depth-only virtual cameras (``images_depths.bin``), the alpha masks
over a per-view "moving object", the LiDAR-augmented chunk init, the GT
cloud ``chunk.ply``, and two chunks with ``center.txt``/``extent.txt``.

The Gaussians come from ``jax.random.PRNGKey(7)`` in JAX, a stream torch
cannot reproduce: pass ``rows=`` (the five arrays of ``random_gaussians``)
to build JAX's project, else they are drawn from ``data/toy.
random_gaussians`` with a ``torch.Generator`` seeded 7.  The numpy draws
(corruption colours, SfM subset and jitter, LiDAR jitter) are JAX's, in
JAX's order.  Images, masks and depths are written with ``data/png``.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from ..data import colmap, png
from ..data.ply import store_point_cloud
from ..data.toy import lookat_camera, random_gaussians
from ..device import DEFAULT_DEVICE, resolve_device
from ..ops.rasterize import RasterConfig, rasterize
from ..pipeline.full_train import ProjectPaths

W, H = 128, 96


def make_project(root, n: int = 400, n_views: int = 16, width=None,
                 height=None, held_out: int = 1, *, with_depths=False,
                 depth_cams: int = 0, with_masks=False, lidar=False,
                 with_gt_cloud=False, sfm_keep: float = 1.0,
                 sfm_noise: float = 0.01, rows=None,
                 device: str | torch.device = DEFAULT_DEVICE) -> ProjectPaths:
    """Write the project under ``root`` and return its ``ProjectPaths``.
    The knobs are those of the JAX fixture (see its docstring); ``rows``
    are the five Gaussian arrays (means, scales, quats, opacities, sh) to
    use in place of the seeded draw; the oracle renders on ``device``."""
    dev = resolve_device(device)
    width = width or W
    height = height or H
    if rows is None:
        rows = random_gaussians(torch.Generator().manual_seed(7), n,
                                sh_degree=3, extent=2.0, device="cpu")
    means, scales, quats, opac, sh = (
        torch.tensor(np.asarray(x.cpu() if isinstance(x, torch.Tensor)
                                else x, np.float32)) for x in rows)
    # Flatten to a street-like slab along x; nearly-diffuse GT (a strongly
    # view-dependent GT caps held-out PSNR regardless of pipeline quality).
    means[:, 2] *= 0.2
    sh[:, 1:, :] *= 0.1
    g_rows = tuple(x.to(dev) for x in (means, scales, quats, opac, sh))
    means_np, sh_np = means.numpy(), sh.numpy()

    cameras = {1: colmap.ColmapCamera(
        1, "PINHOLE", width, height, np.array(
            [width / (2 * math.tan(0.5)), height / (2 * math.tan(0.4)),
             width / 2, height / 2]))}
    images = {}
    proj = ProjectPaths(Path(root))
    img_dir, depth_dir, mask_dir = (proj.images_dir, proj.depths_dir,
                                    proj.masks_dir)
    img_dir.mkdir(parents=True)
    if with_depths:
        depth_dir.mkdir(parents=True)
    if with_masks:
        mask_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    depth_params = {}
    oracle = RasterConfig(method="oracle")

    def render_view(cam_pos, w, h, supersample=2):
        cam_hi = lookat_camera(cam_pos, np.zeros(3), w * supersample,
                               h * supersample, device=dev)
        with torch.no_grad():
            out = rasterize(*g_rows, cam_hi, 3, torch.zeros(3, device=dev),
                            oracle)
        hi = torch.clamp(out["render"], 0, 1)
        img = hi.reshape(3, h, supersample, w, supersample).mean(
            dim=(2, 4)).cpu().numpy()
        inv = out["depth"][0].reshape(h, supersample, w, supersample).mean(
            dim=(1, 3)).cpu().numpy()
        return img, inv

    def save_depth(stem, inv):
        dmax = max(float(inv.max()), 1e-6)
        raw = np.clip(inv / dmax * 65535.0, 0, 65535).astype(np.uint16)
        png.write_png(depth_dir / f"{stem}.png", raw)
        depth_params[stem] = {"scale": dmax, "offset": 0.0}

    def colmap_image(image_id, cam, name):
        w2c = cam.viewmatrix.cpu().numpy()
        return colmap.ColmapImage(
            image_id, colmap.rotmat2qvec(w2c[:3, :3]), w2c[:3, 3], 1, name,
            np.zeros((0, 2)), np.zeros(0, np.int64))

    for i in range(n_views):
        ang = 2 * math.pi * i / n_views
        pos = np.array([2.2 * math.cos(ang), 2.2 * math.sin(ang), 1.4])
        cam = lookat_camera(pos, np.zeros(3), width, height, device="cpu")
        img, inv = render_view(pos, width, height)
        name = f"view{i:03d}.png"
        if with_masks and i >= held_out:
            # "Moving object" on TRAIN views only: a random colour block at
            # a view-dependent place, and its alpha mask.
            bw, bh = width // 4, height // 4
            x0 = int((width - bw) * ((i * 7) % 11) / 10)
            y0 = int((height - bh) * ((i * 5) % 7) / 6)
            img[:, y0:y0 + bh, x0:x0 + bw] = rng.uniform(0, 1, size=(3, 1, 1))
            m = np.full((height, width), 255, np.uint8)
            m[y0:y0 + bh, x0:x0 + bw] = 0
            png.write_png(mask_dir / f"{name}.png", m)
        png.write_png(img_dir / name,
                      (img.transpose(1, 2, 0) * 255).astype(np.uint8))
        if with_depths:
            save_depth(f"view{i:03d}", inv)
        images[i + 1] = colmap_image(i + 1, cam, name)

    # Depth-only virtual cameras: an offset, lower ring.
    dimages = {}
    for j in range(depth_cams):
        ang = 2 * math.pi * (j + 0.5) / max(depth_cams, 1)
        pos = np.array([2.0 * math.cos(ang), 2.0 * math.sin(ang), 0.9])
        cam = lookat_camera(pos, np.zeros(3), width, height, device="cpu")
        _, inv = render_view(pos, width, height)
        if with_depths:
            save_depth(f"depth{j:03d}", inv)
        dimages[1000 + j] = colmap_image(1000 + j, cam, f"depth{j:03d}.png")

    # SfM init, optionally degraded (subset + jitter).
    keep = rng.random(n) < sfm_keep
    n_sfm = int(keep.sum())
    sfm_xyz = (means_np.astype(np.float64)[keep]
               + sfm_noise * rng.normal(size=(n_sfm, 3)))
    sfm_rgb = np.clip((sh_np[:, 0][keep] * 0.28 + 0.5) * 255, 0,
                      255).astype(np.uint8)
    pts = colmap.ColmapPoints(xyz=sfm_xyz, rgb=sfm_rgb, error=np.zeros(n_sfm),
                              ids=np.arange(n_sfm, dtype=np.int64))

    # Dense accurate points: the LiDAR augmentation and the GT cloud.
    lidar_xyz = means_np.astype(np.float64) + 0.005 * rng.normal(size=(n, 3))
    lidar_rgb = np.clip((sh_np[:, 0] * 0.28 + 0.5) * 255, 0,
                        255).astype(np.uint8)

    aligned = proj.colmap_dir / "sparse" / "0"
    colmap.write_model(cameras, images, pts, aligned)
    held = "".join(f"view{i:03d}.png\n" for i in range(held_out))
    (aligned / "test.txt").write_text(held)
    if with_depths:
        (aligned / "depth_params.json").write_text(json.dumps(depth_params))
    if dimages:
        colmap.write_images_binary(dimages, aligned / "images_depths.bin")

    # Two chunks split at x = 0, every camera in both.
    for ci, (lo, hi) in enumerate(((-10, 0), (0, 10))):
        cdir = proj.chunks_dir / f"{ci}_0"
        sparse = cdir / "sparse" / "0"
        m = (pts.xyz[:, 0] >= lo) & (pts.xyz[:, 0] < hi)
        cxyz, crgb = pts.xyz[m], pts.rgb[m]
        if lidar:
            lm = (lidar_xyz[:, 0] >= lo) & (lidar_xyz[:, 0] < hi)
            cxyz = np.concatenate([cxyz, lidar_xyz[lm]])
            crgb = np.concatenate([crgb, lidar_rgb[lm]])
        cpts = colmap.ColmapPoints(xyz=cxyz, rgb=crgb,
                                   error=np.zeros(len(cxyz)),
                                   ids=np.arange(len(cxyz), dtype=np.int64))
        colmap.write_model(cameras, images, cpts, sparse)
        (sparse / "test.txt").write_text(held)
        if with_depths:
            (sparse / "depth_params.json").write_text(
                json.dumps(depth_params))
        if dimages:
            colmap.write_images_binary(dimages, sparse / "images_depths.bin")
        if with_gt_cloud:
            gm = (lidar_xyz[:, 0] >= lo) & (lidar_xyz[:, 0] < hi)
            store_point_cloud(cdir / "chunk.ply", lidar_xyz[gm],
                              lidar_rgb[gm])
        cx = (lo + hi) / 2 if abs(lo) < 5 and abs(hi) < 5 else np.clip(
            (lo + hi) / 2, -2, 2)
        (cdir / "center.txt").write_text(f"{cx} 0.0 0.0\n")
        (cdir / "extent.txt").write_text("2.0 2.0 2.0\n")
    return proj
