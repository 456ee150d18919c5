"""Monocular depth prior generation — the ``preprocess/generate_depth.py``
wrapper around Depth-Anything-V2.

The counterpart of ``street_sparse_3dgs_tpu/preprocess/mono_depth.py``.  The
reference shells out to the Depth-Anything-V2 repo's ``run.py``
(``generate_depth.py:27-36``: ``--encoder vitl --pred-only --grayscale``)
and consumes its 16-bit inverse-depth PNGs.  This wrapper

  - runs the port's own Depth-Anything module (``depth_anything.py``) on
    ``device`` (the card by default) when ``DEPTH_ANYTHING_CKPT`` names a
    checkpoint file on disk, or
  - invokes a local Depth-Anything-V2 checkout (``DEPTH_ANYTHING_DIR``), or
  - falls back to ``transformers``' Depth-Anything-V2 on ``device`` when
    that package and the weights are already on disk (nothing is
    downloaded), and
  - otherwise raises with the exact command to run elsewhere.

Outputs: per-image 16-bit PNGs (``data/png.py``, no PIL) where larger =
closer (inverse depth, normalised per image — the per-image {scale, offset}
alignment to the COLMAP frame is ``preprocess/depth_scale.py``'s job).
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..data import png
from ..device import DEFAULT_DEVICE, resolve_device

IMAGE_EXTS = (".jpg", ".jpeg", ".png")


def depth_anything_cli_cmd(images_dir, out_dir,
                           encoder: str = "vitl") -> list[str]:
    da_dir = os.environ.get("DEPTH_ANYTHING_DIR",
                            "submodules/Depth-Anything-V2")
    return ["python", f"{da_dir}/run.py", "--encoder", encoder,
            "--pred-only", "--grayscale",
            "--img-path", str(images_dir), "--outdir", str(out_dir)]


def to_16bit(arr: np.ndarray) -> np.ndarray:
    """Per-image min-max normalisation to uint16 (the PNG contract)."""
    lo, hi = float(arr.min()), float(arr.max())
    norm = (arr - lo) / max(hi - lo, 1e-9)
    return (norm * 65535.0).astype(np.uint16)


def _images(images_dir: Path, out_dir: Path):
    """(image path, output PNG path) of every image under ``images_dir``,
    the output's folder made."""
    for img_path in sorted(images_dir.rglob("*")):
        if img_path.suffix.lower() not in IMAGE_EXTS:
            continue
        dst = out_dir / img_path.relative_to(images_dir).with_suffix(".png")
        dst.parent.mkdir(parents=True, exist_ok=True)
        yield img_path, dst


def generate_depth(images_dir, out_dir, encoder: str = "vitl",
                   device=DEFAULT_DEVICE) -> int:
    """Produce inverse-depth PNGs for every image under ``images_dir``
    (recursing one camera-folder level, like the rectified layout).
    Returns the number of maps written."""
    images_dir = Path(images_dir)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    ckpt = os.environ.get("DEPTH_ANYTHING_CKPT", "")
    if ckpt and Path(ckpt).exists():
        return generate_depth_torch(images_dir, out_dir, ckpt, device=device)

    da_dir = os.environ.get("DEPTH_ANYTHING_DIR",
                            "submodules/Depth-Anything-V2")
    if Path(da_dir, "run.py").exists():
        subprocess.run(depth_anything_cli_cmd(images_dir, out_dir,
                                              encoder), check=True)
        return len(list(out_dir.rglob("*.png")))

    dev = resolve_device(device)
    name = (f"depth-anything/Depth-Anything-V2-"
            f"{'Large' if encoder == 'vitl' else 'Small'}-hf")
    try:
        from transformers import (  # noqa: PLC0415
            AutoImageProcessor, AutoModelForDepthEstimation)

        processor = AutoImageProcessor.from_pretrained(
            name, local_files_only=True)
        model = AutoModelForDepthEstimation.from_pretrained(
            name, local_files_only=True).to(dev).eval()
    except Exception as e:  # noqa: BLE001
        cmd = " ".join(depth_anything_cli_cmd(images_dir, out_dir, encoder))
        raise RuntimeError(
            "no Depth-Anything-V2 available (set DEPTH_ANYTHING_CKPT to a "
            "checkpoint file or DEPTH_ANYTHING_DIR to a checkout, or run "
            f"elsewhere:\n  {cmd}\nunderlying error: {e}") from e

    n = 0
    for img_path, dst in _images(images_dir, out_dir):
        img = png.to_rgb(png.read_image(img_path))
        inputs = processor(images=img, return_tensors="pt").to(dev)
        with torch.no_grad():
            out = model(**inputs)
        # What the depth-estimation pipeline returns: the map resized to
        # the image's own size.
        depth = processor.post_process_depth_estimation(
            out, target_sizes=[img.shape[:2]])[0]["predicted_depth"]
        png.write_png(dst, to_16bit(depth.float().cpu().numpy()))
        n += 1
    return n


def generate_depth_torch(images_dir, out_dir, ckpt_path,
                         target: int | None = None,
                         device=DEFAULT_DEVICE) -> int:
    """The port's Depth-Anything (``depth_anything.py``) from the
    checkpoint at ``ckpt_path`` over every image on ``device``, writing the
    16-bit inverse-depth PNGs.  ``target`` (short-side inference
    resolution, default 518 as in the DA-V2 transform) can also come from
    ``DEPTH_ANYTHING_TARGET``."""
    from .depth_anything import infer_inverse_depth, load_checkpoint

    if target is None:
        target = int(os.environ.get("DEPTH_ANYTHING_TARGET", "518"))
    images_dir, out_dir = Path(images_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    model, _ = load_checkpoint(ckpt_path, device)
    n = 0
    for img_path, dst in _images(images_dir, out_dir):
        img = png.to_rgb(png.read_image(img_path))
        depth = infer_inverse_depth(model, img, target=target)
        png.write_png(dst, to_16bit(depth.cpu().numpy()))
        n += 1
    return n
