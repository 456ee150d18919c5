"""Cyclomedia depth-map decoding — the
``ss_utils/depth_scripts/depth_map_to_distances.py`` equivalent.

The proprietary depth renderer emits BGR images whose R/G channels bit-pack
millimeter depth with a variable precision exponent:

    precision = (r >> 6) << 1
    units     = ((r & 63) << 8) | g
    depth_mm  = units << precision

(black pixels = background).  For training these become 16-bit inverse-depth
PNGs plus per-image {scale, offset} so that
``inv_depth = png/65535 · scale + offset`` (the reader contract,
``utils/camera_utils.py:44`` + ``scene/cameras.py:69-88``).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def decode_depth_rgb(depth_image: np.ndarray):
    """[H,W,3] BGR uint8 → (depth_m float64 [H,W], background_mask)."""
    if depth_image.ndim != 3:
        return depth_image.astype(np.float32), depth_image <= 0
    b = depth_image[..., 0].astype(np.int64)
    g = depth_image[..., 1].astype(np.int64)
    r = depth_image[..., 2].astype(np.int64)
    background = (b == 0) & (g == 0) & (r == 0)
    precision = (r >> 6) << 1
    units = ((r & 63) << 8) | g
    depth_m = (units << precision).astype(np.float64) / 1000.0
    depth_m[background] = 0.0
    return depth_m, background


def to_invdepth_png(depth_m: np.ndarray, background: np.ndarray,
                    min_depth: float = 0.1, max_depth: float | None = None):
    """→ (uint16 normalized inverse depth, scale, offset)."""
    valid = (depth_m > min_depth) & ~background
    if max_depth is not None:
        valid &= depth_m < max_depth
    inv = np.zeros_like(depth_m)
    inv[valid] = 1.0 / depth_m[valid]
    if not valid.any():
        return np.zeros(depth_m.shape, np.uint16), 0.0, 0.0
    lo = float(inv[valid].min())
    hi = float(inv[valid].max())
    scale = hi - lo
    if scale <= 0:
        scale = 1.0
    norm = np.zeros_like(inv)
    norm[valid] = (inv[valid] - lo) / scale
    png = (norm * 65535.0).astype(np.uint16)
    return png, scale, lo


def convert_depth_dir(in_dir: str | Path, out_dir: str | Path,
                      params_path: str | Path | None = None,
                      min_depth: float = 0.1) -> dict:
    """Decode every encoded depth image in ``in_dir`` into 16-bit inverse
    depth PNGs + a depth_params.json fragment."""
    from ..data import png

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    params = {}
    for f in sorted(Path(in_dir).iterdir()):
        if f.suffix.lower() not in (".png", ".jpg", ".tiff", ".tif"):
            continue
        rgb = png.read_image(f)
        if rgb.ndim == 3 and rgb.shape[2] >= 3:
            bgr = rgb[..., :3][..., ::-1]
        else:
            bgr = rgb
        depth_m, background = decode_depth_rgb(bgr)
        inv, scale, offset = to_invdepth_png(depth_m, background, min_depth)
        stem = f.stem
        png.write_png(out_dir / f"{stem}.png", inv)
        params[stem] = {"scale": scale, "offset": offset}
    if params_path is not None:
        Path(params_path).write_text(json.dumps(params, indent=1))
    return params
