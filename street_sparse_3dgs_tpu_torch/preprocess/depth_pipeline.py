"""LiDAR → ground-truth depth pipeline driver — the
``ss_utils/ss_generate_depths.py`` equivalent.

The reference's 8-step pipeline (its docstring/step list):
  1. LiDAR .laz → .ply tiles (``prepare_lidar_for_vis2mesh``)
  2. augment recording details with interpolated virtual cameras
  3. COLMAP → vis2mesh camera JSON
  4. vis2mesh Docker: point cloud → mesh
  5. mesh → CTM tiles (ctm_exporter)
  6. recording JSON → .stations + proprietary Docker depth renderer
  7. (renderer output)
  8. Cyclomedia depth decode → 16-bit inverse-depth PNGs + depth_params

Steps 4 and 6 are external Docker containers in the reference and stay
external here (SURVEY.md §2.3: out of TPU scope); this driver runs every
locally-computable step (2, 3, 5, 8 — via ``virtual_cams``, ``native/ctm``'s CTM
writer and ``depth_decode``) and reports exactly what must run elsewhere.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..data import colmap
from . import depth_decode, virtual_cams


def colmap_to_vis2mesh_json(sparse_dir, out_path) -> dict:
    """Step 3 (``depth_scripts/colmap_to_vis2mesh.py:15-50``): cameras +
    poses in vis2mesh's JSON layout ({imgs: [{K, R (c2w), C, name}...]})."""
    cams, images, _ = colmap.read_model(sparse_dir)
    out = {"imgs": []}
    for im in images.values():
        cam = cams[im.camera_id]
        if cam.model == "PINHOLE":
            fx, fy, cx, cy = cam.params
        else:
            fx = fy = cam.params[0]
            cx, cy = cam.params[1], cam.params[2]
        R = colmap.qvec2rotmat(im.qvec)
        C = (-R.T @ im.tvec).tolist()
        out["imgs"].append({
            "name": im.name,
            "width": cam.width, "height": cam.height,
            "K": [[fx, 0, cx], [0, fy, cy], [0, 0, 1]],
            "R": R.tolist(), "C": C})
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text(json.dumps(out, indent=1))
    return out


def mesh_to_ctm_tiles(vertices: np.ndarray, triangles: np.ndarray,
                      out_dir, tile_size: float = 100.0) -> list[Path]:
    """Step 5 (``depth_scripts/ply_mesh_to_ctm.py`` + ctm_exporter): split a
    mesh into x/y tiles and write offset-centred CTM files (the offset keeps
    coordinates small for the 32-bit renderer)."""
    from ..native import ctm

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tri_centers = vertices[triangles].mean(axis=1)
    cells = np.floor(tri_centers[:, :2] / tile_size).astype(np.int64)
    written = []
    for cell in np.unique(cells, axis=0):
        m = (cells == cell[None, :]).all(axis=1)
        tri_sel = triangles[m]
        used, inverse = np.unique(tri_sel, return_inverse=True)
        verts = vertices[used]
        tris = inverse.reshape(-1, 3).astype(np.int32)
        offset = np.array([(cell[0] + 0.5) * tile_size,
                           (cell[1] + 0.5) * tile_size, 0.0])
        path = out_dir / f"tile_{cell[0]}_{cell[1]}.ctm"
        ctm.save_ctm(path, verts.astype(np.float32), tris,
                        user_offset=offset)
        # Sidecar offset so the renderer can restore world coordinates.
        (path.with_suffix(".offset.json")).write_text(
            json.dumps(offset.tolist()))
        written.append(path)
    return written


def generate_depths(project_dir, num_interpolations: int = 1,
                    directions: str = "2") -> dict:
    """Drive the locally-computable steps over a project directory and
    return a report of what ran and what needs external tools."""
    proj = Path(project_dir)
    extras = proj / "camera_calibration" / "extras"
    aligned = proj / "camera_calibration" / "aligned" / "sparse" / "0"
    report = {"ran": [], "external": []}

    rec = extras / "recording_details_train.json"
    if rec.exists() and (aligned / "translation.json").exists():
        info = virtual_cams.augment_recording_details(
            rec, aligned, directions=directions,
            num_interpolations=num_interpolations)
        report["ran"].append(("augment_recording_details", info))
    else:
        report["external"].append(
            "step 2 skipped: recording_details_train.json or "
            "translation.json missing")

    if aligned.exists() and (aligned / "cameras.bin").exists():
        colmap_to_vis2mesh_json(aligned, extras / "vis2mesh_cams.json")
        report["ran"].append(("colmap_to_vis2mesh", str(extras
                                                       / "vis2mesh_cams.json")))

    report["external"].append(
        "step 4 (vis2mesh point-cloud meshing) and step 6 (proprietary "
        "depth renderer) run in Docker as in the reference; afterwards "
        "call preprocess.depth_pipeline.mesh_to_ctm_tiles on the mesh and "
        "preprocess.depth_decode.convert_depth_dir on the renders")
    return report


def finalize_depths(encoded_depth_dir, out_depths_dir,
                    params_path=None) -> dict:
    """Step 8: decode the proprietary renderer's output into training-ready
    inverse-depth PNGs + depth params."""
    return depth_decode.convert_depth_dir(encoded_depth_dir, out_depths_dir,
                                          params_path)
