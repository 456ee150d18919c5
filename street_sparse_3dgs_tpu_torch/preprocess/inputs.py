"""Raw-input organization utilities — ``ss_utils/create_inputs.py``,
``ss_utils/colmap_fix.py`` and ``preprocess/copy_file_to_chunks.py``
equivalents.

``create_inputs`` copies/renames raw panorama cube faces into the
``inputs/images/cam<k>/`` layout the calibration expects (the reference also
injects GPS EXIF for the SfM matcher — positions here flow through the
recording JSON instead, which the matchers consume directly).
``colmap_fix`` prunes/renames camera folders for reduced face sets.
``copy_file_to_chunks`` fans a shared file (test.txt, depth_params.json)
out into every chunk's sparse dir.
"""

from __future__ import annotations

import re
import shutil
from pathlib import Path

FACE_ORDER = ("f1", "f2", "r1", "r2", "b1", "b2", "l1", "l2", "u1", "u2")


def create_inputs(raw_dir, inputs_dir,
                  faces=FACE_ORDER[:8]) -> int:
    """Organize raw face images named ``<ImageId>_<face>.jpg`` (or nested
    ``<face>/<ImageId>.jpg``) into ``inputs/images/cam<k>/<ImageId>.jpg``.
    Returns the number of files placed."""
    raw = Path(raw_dir)
    out = Path(inputs_dir) / "images"
    face_to_cam = {f: i + 1 for i, f in enumerate(faces)}
    n = 0
    pat = re.compile(r"(?P<id>.+)_(?P<face>[frblu][12])$")
    for f in sorted(raw.rglob("*")):
        if f.suffix.lower() not in (".jpg", ".jpeg", ".png"):
            continue
        m = pat.match(f.stem)
        if m:
            image_id, face = m.group("id"), m.group("face")
        elif f.parent.name in face_to_cam:
            image_id, face = f.stem, f.parent.name
        else:
            continue
        if face not in face_to_cam:
            continue
        dst = out / f"cam{face_to_cam[face]}" / f"{image_id}{f.suffix}"
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(f, dst)
        n += 1
    return n


def reduce_camera_folders(images_dir, keep_faces=("f1", "r1", "b1", "l1"),
                          all_faces=FACE_ORDER[:8]) -> None:
    """The colmap_fix 6/4-face variant: drop camera folders for unused faces
    and renumber the kept ones densely (cam1..camK)."""
    images_dir = Path(images_dir)
    keep_cams = [all_faces.index(f) + 1 for f in keep_faces]
    tmp = images_dir.parent / (images_dir.name + "_reduced")
    tmp.mkdir(parents=True, exist_ok=True)
    for new_idx, old_cam in enumerate(sorted(keep_cams), start=1):
        src = images_dir / f"cam{old_cam}"
        if src.exists():
            shutil.move(str(src), str(tmp / f"cam{new_idx}"))
    for leftover in images_dir.glob("cam*"):
        shutil.rmtree(leftover)
    for d in tmp.iterdir():
        shutil.move(str(d), str(images_dir / d.name))
    tmp.rmdir()


def copy_file_to_chunks(file_path, chunks_dir,
                        dest_rel: str = "sparse/0") -> int:
    """Copy a shared artifact into every chunk (the reference's
    ``copy_file_to_chunks.py`` / ``copy_test_and_depth_params_files.py``)."""
    src = Path(file_path)
    n = 0
    for chunk in sorted(Path(chunks_dir).iterdir()):
        dst_dir = chunk / dest_rel
        if dst_dir.exists():
            shutil.copy2(src, dst_dir / src.name)
            n += 1
    return n


def _dilate(mask: "np.ndarray", k: int = 5) -> "np.ndarray":
    """Binary max-filter with a k×k square element (numpy shifts — no cv2
    dependency)."""
    import numpy as np

    r = k // 2
    padded = np.pad(mask, r, mode="edge")
    out = np.zeros_like(mask)
    for dy in range(k):
        for dx in range(k):
            out = np.maximum(
                out, padded[dy:dy + mask.shape[0], dx:dx + mask.shape[1]])
    return out


def black_mask(project_dir, dilate: int = 5, quality: int = 95) -> int:
    """Blacken masked-out pixels of every rectified image in place
    (reference ``preprocess/black_mask.py``: 5×5 mask dilation, then
    ``img[mask == 0] = 0`` re-encoded at JPEG quality 95).  Masks live in
    ``rectified/masks/<same relpath>.png``; images may sit flat or in
    per-camera folders.  Returns the number of images rewritten."""
    import numpy as np

    from ..data import jpeg, png

    root = Path(project_dir) / "camera_calibration" / "rectified"
    images_dir, masks_dir = root / "images", root / "masks"
    done = 0
    for img_path in sorted(images_dir.rglob("*")):
        if img_path.suffix.lower() not in (".jpg", ".jpeg", ".png"):
            continue
        rel = img_path.relative_to(images_dir)
        mask_path = masks_dir / rel.with_suffix(".png")
        if not mask_path.exists():
            continue
        img = png.to_rgb(png.read_image(img_path)).copy()
        mask = png.to_grey(png.read_image(mask_path))
        if mask.shape != img.shape[:2]:
            mask = png.resize_nearest_pil(mask, (img.shape[1], img.shape[0]))
        keep = _dilate((mask > 0).astype(np.uint8), dilate)
        img[keep == 0] = 0
        if img_path.suffix.lower() in (".jpg", ".jpeg"):
            jpeg.write_jpeg(img_path, img, quality)
        else:
            png.write_png(img_path, img)
        done += 1
    return done
