"""Per-image monocular-depth alignment — ``preprocess/make_depth_scale.py``
(and its per-chunk driver ``make_chunks_depth_scale.py``) equivalents.

For every image with SfM points: project the triangulated points, sample the
mono inverse-depth map at those pixels, and robustly match the two inverse
depth distributions by median/mean-absolute-deviation:

    scale  = MAD(inv_colmap) / MAD(inv_mono)
    offset = median(inv_colmap) − median(inv_mono)·scale

(reference ``make_depth_scale.py:19-75``).  Degenerate images (≤10 valid
samples or near-constant colmap depth) get scale = offset = 0 (the training
loader then treats their depth as unreliable).  Results go to
``depth_params.json`` keyed by image stem.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..data import colmap


def image_depth_params(image: colmap.ColmapImage, cam: colmap.ColmapCamera,
                       points_by_id: dict[int, np.ndarray],
                       invmonodepthmap: np.ndarray) -> dict:
    """Fit {scale, offset} for one image.  ``invmonodepthmap``: [h,w] float
    in [0,1] (16-bit PNG / 65535)."""
    pids = image.point3D_ids
    mask = pids >= 0
    rows = [points_by_id.get(int(p)) for p in pids[mask]]
    ok = [r is not None for r in rows]
    if not any(ok):
        return {"scale": 0.0, "offset": 0.0}
    pts = np.stack([r for r in rows if r is not None])
    xys = image.xys[mask][np.asarray(ok)]

    R = colmap.qvec2rotmat(image.qvec)
    cam_pts = pts @ R.T + image.tvec
    inv_colmap = 1.0 / np.maximum(cam_pts[:, 2], 1e-12)

    s = invmonodepthmap.shape[0] / cam.height
    maps = xys * s
    h, w = invmonodepthmap.shape[:2]
    valid = ((maps[:, 0] >= 0) & (maps[:, 1] >= 0)
             & (maps[:, 0] < cam.width * s) & (maps[:, 1] < cam.height * s)
             & (cam_pts[:, 2] > 0))
    if valid.sum() <= 10 or (inv_colmap[valid].max()
                             - inv_colmap[valid].min()) <= 1e-3:
        return {"scale": 0.0, "offset": 0.0}
    mx = np.clip(maps[valid, 0], 0, w - 1)
    my = np.clip(maps[valid, 1], 0, h - 1)
    # Bilinear sample of the mono map at the projected feature locations.
    x0 = np.floor(mx).astype(int)
    y0 = np.floor(my).astype(int)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    fx = mx - x0
    fy = my - y0
    inv_mono = ((1 - fx) * (1 - fy) * invmonodepthmap[y0, x0]
                + fx * (1 - fy) * invmonodepthmap[y0, x1]
                + (1 - fx) * fy * invmonodepthmap[y1, x0]
                + fx * fy * invmonodepthmap[y1, x1])
    inv_col = inv_colmap[valid]

    t_colmap = float(np.median(inv_col))
    s_colmap = float(np.mean(np.abs(inv_col - t_colmap)))
    t_mono = float(np.median(inv_mono))
    s_mono = float(np.mean(np.abs(inv_mono - t_mono)))
    if s_mono <= 1e-12:
        return {"scale": 0.0, "offset": 0.0}
    scale = s_colmap / s_mono
    return {"scale": scale, "offset": t_colmap - t_mono * scale}


def make_depth_scale(sparse_dir: str | Path, depths_dir: str | Path,
                     out_path: str | Path | None = None) -> dict:
    """Fit every image in a COLMAP model; writes
    ``<sparse_dir>/depth_params.json`` (unless ``out_path`` overrides)."""
    from ..data import png

    cams, images, pts = colmap.read_model(sparse_dir)
    points_by_id = {int(pid): xyz for pid, xyz in zip(pts.ids, pts.xyz)} \
        if pts is not None else {}
    out = {}
    for im in images.values():
        stem = im.name.rsplit(".", 1)[0]
        f = Path(depths_dir) / f"{stem}.png"
        if not f.exists():
            continue
        raw = np.asarray(png.read_image(f), np.float32)
        if raw.ndim == 3:
            raw = raw[..., 0]
        raw = raw / (2 ** 16)
        out[stem] = image_depth_params(im, cams[im.camera_id], points_by_id,
                                       raw)
    path = Path(out_path) if out_path else Path(sparse_dir) \
        / "depth_params.json"
    path.write_text(json.dumps(out, indent=1))
    return out


def make_chunks_depth_scale(chunks_dir: str | Path,
                            depths_dir: str | Path) -> None:
    """Run depth-scale fitting for every chunk (the
    ``make_chunks_depth_scale.py`` driver)."""
    for chunk in sorted(Path(chunks_dir).iterdir()):
        sparse = chunk / "sparse" / "0"
        if sparse.exists():
            make_depth_scale(sparse, depths_dir)
