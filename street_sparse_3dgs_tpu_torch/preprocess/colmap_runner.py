"""Orchestration of the external ``colmap`` binary —
``preprocess/generate_colmap.py`` / ``prepare_chunk.py`` equivalents.

COLMAP itself stays an external CLI dependency (exactly as in the reference,
SURVEY.md §1 L6); this module sequences its invocations for the two
calibration workflows:

  - ``cal_sfm`` (fork default, ``generate_colmap.py:163-290``): known-pose
    triangulation — fill_database → distance matcher (50 pairs) →
    feature_extractor with existing cameras → matches_importer →
    point_triangulator (poses fixed) → 2× pose-frozen bundle_adjuster;
  - ``refine_chunk`` (``prepare_chunk.py:26-190``): per-chunk refinement —
    fill_database → distance matcher (200 pairs) → feature_extractor →
    matches_importer → 2× (point_triangulator + bundle_adjuster) →
    rigid re-registration back to the original frame (undo drift).

Every invocation is logged; a missing ``colmap`` executable raises a clear
error listing the exact commands so they can run elsewhere.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

from ..data import colmap as colmap_io
from . import colmap_db, matchers


DRY_RUN = False
"""When True, external ``colmap`` invocations are logged, not executed, and
model-consuming local steps are skipped if their input artifact is absent —
the command-sequence contract stays testable without COLMAP installed."""


def colmap_available() -> bool:
    return shutil.which("colmap") is not None


def _run(cmd: list[str], log: list[str]) -> None:
    log.append(" ".join(cmd))
    if DRY_RUN:
        return
    if not colmap_available():
        raise RuntimeError(
            "the `colmap` executable is not on PATH; run these commands on "
            "a machine with COLMAP:\n" + "\n".join(log))
    subprocess.run(cmd, check=True)


def _ready(path: Path, log: list[str], step: str) -> bool:
    """Gate a local step on its input model existing; under DRY_RUN a
    missing artifact just logs the step instead of failing."""
    if (Path(path) / "cameras.bin").exists():
        return True
    if DRY_RUN:
        log.append(f"[dry-run] {step}")
        return False
    raise RuntimeError(f"{step}: expected model at {path}")


def triangulate_known_poses(sparse_in: str | Path, images_dir: str | Path,
                            workdir: str | Path, sparse_out: str | Path,
                            n_pairs: int = 50,
                            n_features: int = 16384) -> list[str]:
    """The cal_sfm workflow: triangulate scene points for known camera poses
    (the reference's fork-default calibration)."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    db = workdir / "database.db"
    pairs = workdir / "pairs.txt"
    log: list[str] = []

    cams, images, _ = colmap_io.read_model(sparse_in)
    colmap_db.fill_database(db, cams, images)
    matchers.make_distance_pairs(sparse_in, pairs, n_neighbors=n_pairs)

    _run(["colmap", "feature_extractor", "--database_path", str(db),
          "--image_path", str(images_dir),
          "--SiftExtraction.max_num_features", str(n_features),
          "--ImageReader.existing_camera_id", "-1"], log)
    _run(["colmap", "matches_importer", "--database_path", str(db),
          "--match_list_path", str(pairs)], log)
    Path(sparse_out).mkdir(parents=True, exist_ok=True)
    _run(["colmap", "point_triangulator", "--database_path", str(db),
          "--image_path", str(images_dir), "--input_path", str(sparse_in),
          "--output_path", str(sparse_out),
          "--Mapper.fix_existing_images", "1"], log)
    for _ in range(2):
        _run(["colmap", "bundle_adjuster", "--input_path", str(sparse_out),
              "--output_path", str(sparse_out),
              "--BundleAdjustment.refine_extrinsics", "0"], log)
    return log


def refine_chunk(chunk_sparse: str | Path, images_dir: str | Path,
                 workdir: str | Path, n_pairs: int = 200) -> list[str]:
    """Per-chunk triangulation + bundle adjustment, then rigid
    re-registration to the original frame (``prepare_chunk.py`` +
    ``transform_colmap.py`` semantics: the refined model is aligned back so
    chunk bounds stay valid)."""
    import numpy as np

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    db = workdir / "database.db"
    pairs = workdir / "pairs.txt"
    refined = workdir / "refined"
    log: list[str] = []

    cams, images, _ = colmap_io.read_model(chunk_sparse)
    colmap_db.fill_database(db, cams, images)
    matchers.make_distance_pairs(chunk_sparse, pairs, n_neighbors=n_pairs)

    _run(["colmap", "feature_extractor", "--database_path", str(db),
          "--image_path", str(images_dir)], log)
    _run(["colmap", "matches_importer", "--database_path", str(db),
          "--match_list_path", str(pairs)], log)
    refined.mkdir(parents=True, exist_ok=True)
    for _ in range(2):
        _run(["colmap", "point_triangulator", "--database_path", str(db),
              "--image_path", str(images_dir),
              "--input_path", str(chunk_sparse),
              "--output_path", str(refined)], log)
        _run(["colmap", "bundle_adjuster", "--input_path", str(refined),
              "--output_path", str(refined)], log)

    # Undo drift: rigid-align refined camera centers onto the originals
    # (umeyama without scale) and rewrite into the chunk dir.
    _, ref_images, ref_pts = colmap_io.read_model(refined)
    orig_c = {im.name: -colmap_io.qvec2rotmat(im.qvec).T @ im.tvec
              for im in images.values()}
    new_c = {im.name: -colmap_io.qvec2rotmat(im.qvec).T @ im.tvec
             for im in ref_images.values()}
    common = [n for n in orig_c if n in new_c]
    A = np.stack([new_c[n] for n in common])
    B = np.stack([orig_c[n] for n in common])
    mu_a, mu_b = A.mean(0), B.mean(0)
    U, _, Vt = np.linalg.svd((A - mu_a).T @ (B - mu_b))
    R = (U @ Vt).T
    if np.linalg.det(R) < 0:
        Vt[-1] *= -1
        R = (U @ Vt).T
    t = mu_b - R @ mu_a

    from .reorient import apply_transform

    # apply_transform rotates via center @ rot; wrap the affine manually.
    out_images = {}
    for k, im in ref_images.items():
        Rc = colmap_io.qvec2rotmat(im.qvec)
        center = -Rc.T @ im.tvec
        new_center = R @ center + t
        c2w = R @ Rc.T
        R_new = c2w.T
        out_images[k] = colmap_io.ColmapImage(
            im.id, colmap_io.rotmat2qvec(R_new), -R_new @ new_center,
            im.camera_id, im.name, im.xys, im.point3D_ids)
    out_pts = None
    if ref_pts is not None:
        out_pts = colmap_io.ColmapPoints(
            xyz=ref_pts.xyz @ R.T + t, rgb=ref_pts.rgb, error=ref_pts.error,
            ids=ref_pts.ids, track_image_ids=ref_pts.track_image_ids,
            track_point2d_idxs=ref_pts.track_point2d_idxs)
    colmap_io.write_model(cams, out_images, out_pts, chunk_sparse)
    return log


def _exif_gps_positions(images_dir: str | Path) -> dict:
    """Per-image (lat, lon) from EXIF, name-keyed relative to ``images_dir``
    (reference ``make_colmap_custom_matcher.py:20-40`` reads the same tags).
    Images without GPS are omitted."""
    from ..data.jpeg import exif_gps

    def to_deg(v, ref):
        d = float(v[0]) + float(v[1]) / 60 + float(v[2]) / 3600
        return -d if ref in ("S", "W") else d

    images_dir = Path(images_dir)
    out = {}
    for p in sorted(images_dir.rglob("*")):
        if p.suffix.lower() not in (".jpg", ".jpeg", ".png"):
            continue
        name = p.relative_to(images_dir).as_posix()
        try:
            gps = exif_gps(p)  # GPSInfo IFD tags 1-4
            if gps and 2 in gps and 4 in gps:
                out[name] = [to_deg(gps[2], gps.get(1, "N")),
                             to_deg(gps[4], gps.get(3, "E"))]
        except Exception:
            continue
    return out


def sfm_reconstruction(images_dir: str | Path, workdir: str | Path,
                       sparse_out: str | Path,
                       n_features: int = 16384) -> list[str]:
    """The full-SfM calibration workflow (``generate_colmap.py:83-151``):
    feature_extractor (single OPENCV camera, 16384 features) → global custom
    matcher → matches_importer → hierarchical_mapper (relaxed global-BA
    tolerance 0.1) → simplify_images on the ``0`` submodel."""
    from .reorient import simplify_images

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    db = workdir / "database.db"
    pairs = workdir / "matching.txt"
    log: list[str] = []

    positions = _exif_gps_positions(images_dir)
    names = sorted(
        p.relative_to(Path(images_dir)).as_posix()
        for p in Path(images_dir).rglob("*")
        if p.suffix.lower() in (".jpg", ".jpeg", ".png"))
    if positions and len(positions) == len(names):
        matchers.make_matcher_pairs(positions, pairs)
    else:  # no (complete) GPS: sequential + quadratic pairs only
        matchers.make_matcher_pairs(
            {n: [0.0, 0.0] for n in names}, pairs, n_gps=0)

    _run(["colmap", "feature_extractor", "--database_path", str(db),
          "--image_path", str(images_dir),
          "--ImageReader.single_camera", "1",
          "--ImageReader.default_focal_length_factor", "0.5",
          "--ImageReader.camera_model", "OPENCV",
          "--SiftExtraction.max_num_features", str(n_features)], log)
    _run(["colmap", "matches_importer", "--database_path", str(db),
          "--match_list_path", str(pairs)], log)
    sparse_out = Path(sparse_out)
    sparse_out.mkdir(parents=True, exist_ok=True)
    _run(["colmap", "hierarchical_mapper", "--database_path", str(db),
          "--image_path", str(images_dir),
          "--output_path", str(sparse_out),
          "--Mapper.ba_global_function_tolerance", "0.1"], log)
    model0 = sparse_out / "0"
    if _ready(model0, log, f"simplify_images {model0}"):
        simplify_images(model0, model0)
        log.append(f"simplify_images {model0}")
    return log


def _masks_model(sparse_in: Path, masks_model_dir: Path) -> None:
    """images.bin copy with ``.jpg`` names swapped to ``.png`` so masks ride
    the same undistortion (``generate_colmap.py`` replace_images_by_masks)."""
    cams, images, pts = colmap_io.read_model(sparse_in)
    out = {k: colmap_io.ColmapImage(
        im.id, im.qvec, im.tvec, im.camera_id,
        im.name[:-len(Path(im.name).suffix)] + ".png",
        im.xys, im.point3D_ids) for k, im in images.items()}
    colmap_io.write_model(cams, out, pts, masks_model_dir)


def make_mask_uint8(in_dir: str | Path, out_dir: str | Path) -> int:
    """Undistorted RGBA masks → eroded single-channel uint8 PNGs
    (``preprocess/make_mask_uint8.py``: alpha>250, 3×3 erosion)."""
    import numpy as np

    from ..data import png

    in_dir, out_dir = Path(in_dir), Path(out_dir)
    n = 0
    for p in sorted(in_dir.rglob("*.png")):
        arr = png.read_image(p)
        alpha = arr[..., -1] if arr.ndim == 3 else arr
        mask = (alpha > 250).astype(np.uint8)
        # 3x3 binary erosion (min filter) without cv2/scipy dependency.
        pad = np.pad(mask, 1, constant_values=0)
        er = np.ones_like(mask)
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                er &= pad[dy:dy + mask.shape[0], dx:dx + mask.shape[1]]
        dest = out_dir / p.relative_to(in_dir)
        dest.parent.mkdir(parents=True, exist_ok=True)
        png.write_png(dest, er * 255)
        n += 1
    return n


def generate_colmap_project(project_dir: str | Path,
                            images_dir: str | Path | None = None,
                            masks_dir: str | Path | None = None,
                            calibration: str = "cal_sfm") -> list[str]:
    """End-to-end calibration driver (``preprocess/generate_colmap.py``
    __main__): build the unrectified model (``sfm`` via hierarchical mapper
    or ``cal_sfm`` via known-pose triangulation), undistort images (and
    masks) to ``rectified/``, then align to ``aligned/sparse/0``
    (auto_reorient for sfm; straight copy for cal_sfm)."""
    import shutil as _sh

    from .reorient import auto_reorient

    project_dir = Path(project_dir)
    if images_dir is None:
        images_dir = project_dir / "inputs" / "images"
    if masks_dir is None:
        cand = project_dir / "inputs" / "masks"
        masks_dir = cand if cand.exists() else None
    unrect = project_dir / "camera_calibration" / "unrectified"
    rect = project_dir / "camera_calibration" / "rectified"
    aligned = project_dir / "camera_calibration" / "aligned" / "sparse" / "0"
    for d in (unrect / "sparse", rect, aligned):
        d.mkdir(parents=True, exist_ok=True)
    log: list[str] = []

    if calibration == "sfm":
        log += sfm_reconstruction(images_dir, unrect, unrect / "sparse")
        model0 = unrect / "sparse" / "0"
    elif calibration == "cal_sfm":
        model0 = unrect / "sparse" / "0"
        log += triangulate_known_poses(
            model0, images_dir, unrect, unrect / "bundle_adjustment")
        if _ready(unrect / "bundle_adjustment", log,
                  "copy bundle_adjustment -> sparse/0"):
            for f in ("cameras.bin", "images.bin", "points3D.bin"):
                _sh.copy(unrect / "bundle_adjustment" / f, model0 / f)
    else:
        raise ValueError(f"unknown calibration workflow {calibration!r}")

    _run(["colmap", "image_undistorter", "--image_path", str(images_dir),
          "--input_path", str(model0), "--output_path", str(rect),
          "--output_type", "COLMAP", "--max_image_size", "2048"], log)

    if masks_dir is not None:
        masks_model = model0 / "masks"
        if _ready(model0, log, "replace_images_by_masks"):
            _masks_model(model0, masks_model)
        tmp = project_dir / "camera_calibration" / "tmp"
        _run(["colmap", "image_undistorter", "--image_path", str(masks_dir),
              "--input_path", str(masks_model), "--output_path", str(tmp),
              "--output_type", "COLMAP", "--max_image_size", "2048"], log)
        n = make_mask_uint8(tmp / "images", rect / "masks")
        log.append(f"make_mask_uint8 -> {n} masks")
        _sh.rmtree(tmp, ignore_errors=True)

    if calibration == "sfm":
        if _ready(rect / "sparse", log, f"auto_reorient -> {aligned}"):
            auto_reorient(rect / "sparse", aligned)
            log.append(f"auto_reorient {rect/'sparse'} -> {aligned}")
    elif _ready(rect / "sparse", log, f"copy rectified -> {aligned}"):
        for f in ("cameras.bin", "images.bin", "points3D.bin"):
            _sh.copy(rect / "sparse" / f, aligned / f)
    return log
