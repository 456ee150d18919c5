"""Depth-only virtual camera generation — the
``ss_utils/depth_scripts/augment_recording_details.py`` equivalent.

Between every pair of consecutive (time-ordered) recordings, insert
``num_interpolations`` virtual recordings with linearly interpolated
position/height/yaw (``interpolate_recordings``, ``:269-399``), build their
cube-face cameras with the same extrinsics math as the calibration module,
and write them as a COLMAP ``images_depths.bin`` (ids remapped densely,
``:405-433``).  These virtual views have no photographs — only LiDAR-derived
depth — and train through the depth-only branch (hinge + pure depth loss).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..data import colmap
from .calibration import DEFAULT_FACES, face_rotation

FACE_SETS = {
    "1": ("f1", "r1", "b1", "l1"),
    "2": DEFAULT_FACES,
    "3": DEFAULT_FACES + ("u1", "u2"),
    "4": ("f1", "r1", "b1", "l1", "u1", "u2"),
}


def _lerp_angle(a: float, b: float, t: float) -> float:
    """Interpolate angles in degrees the short way around."""
    d = ((b - a + 180.0) % 360.0) - 180.0
    return a + t * d


def interpolate_recordings(records: list[dict], num_interpolations: int = 1,
                           max_gap_m: float = 10.0) -> list[dict]:
    """Virtual recordings between consecutive originals (skipping pairs
    farther than ``max_gap_m`` apart — separate drive passes)."""
    records = sorted(records, key=lambda r: r.get("RecordedAt",
                                                  r["ImageId"]))
    out = []
    for a, b in zip(records, records[1:]):
        dist = float(np.hypot(b["X"] - a["X"], b["Y"] - a["Y"]))
        if dist > max_gap_m:
            continue
        for j in range(num_interpolations):
            t = (j + 1) / (num_interpolations + 1)
            out.append({
                "ImageId": f"{a['ImageId']}_interp{j}",
                "X": a["X"] + t * (b["X"] - a["X"]),
                "Y": a["Y"] + t * (b["Y"] - a["Y"]),
                "Height": a.get("Height", 0.0) + t * (
                    b.get("Height", 0.0) - a.get("Height", 0.0)),
                "Yaw": _lerp_angle(a.get("Yaw", 0.0), b.get("Yaw", 0.0), t),
                "VehicleDirection": _lerp_angle(
                    a.get("VehicleDirection", 0.0),
                    b.get("VehicleDirection", 0.0), t),
            })
    return out


def build_depth_cameras(virtual_records: list[dict],
                        translation: tuple[float, float],
                        faces=DEFAULT_FACES,
                        start_id: int = 0) -> dict[int, colmap.ColmapImage]:
    """Cube-face COLMAP images for the virtual recordings (ids dense from
    ``start_id``; names keep the rectified layout so depth PNGs resolve)."""
    images = {}
    iid = start_id
    x_c, y_c = translation
    for rec in virtual_records:
        pos = np.array([rec["X"] - x_c, rec["Y"] - y_c,
                        rec.get("Height", 0.0)], np.float64)
        for fi, face in enumerate(faces):
            R = face_rotation(face, rec.get("VehicleDirection", 0.0),
                              rec.get("Yaw", 0.0))
            images[iid] = colmap.ColmapImage(
                iid, colmap.rotmat2qvec(R), -R @ pos, fi + 1,
                f"cam{fi + 1}/{rec['ImageId']}.jpg",
                np.zeros((0, 2)), np.zeros(0, np.int64))
            iid += 1
    return images


def augment_recording_details(
    recording_details: str | Path | dict,
    output_sparse: str | Path,
    translation: tuple[float, float] | None = None,
    directions: str = "2",
    num_interpolations: int = 1,
) -> dict:
    """Generate virtual depth-only cameras and write
    ``<output_sparse>/images_depths.bin`` (+ the augmented recording JSON
    next to it).  ``translation`` defaults to the values stored in
    ``<output_sparse>/translation.json``."""
    if not isinstance(recording_details, dict):
        recording_details = json.loads(Path(recording_details).read_text())
    records = recording_details["RecordingProperties"]
    out = Path(output_sparse)
    if translation is None:
        blob = json.loads((out / "translation.json").read_text())
        translation = (blob["x_translation"], blob["y_translation"])

    virtual = interpolate_recordings(records, num_interpolations)
    faces = FACE_SETS[directions]
    images = build_depth_cameras(virtual, translation, faces)
    colmap.write_images_binary(images, out / "images_depths.bin")
    (out / "recording_details_depths.json").write_text(
        json.dumps({"RecordingProperties": virtual}, indent=1))
    return {"n_virtual_recordings": len(virtual),
            "n_depth_cameras": len(images)}
