"""COLMAP-from-known-calibration — the
``ss_utils/generate_colmap_calibration.py`` equivalent.

Builds a COLMAP sparse model directly from Cyclomedia panorama recording
metadata (``recording_details.json``): per-recording cube faces become
PINHOLE cameras with f = face_size/2 (90° FOV, ``:306-310``), extrinsics
from the recording yaw + per-face yaw/pitch offsets (``:311-357``), and a
centering translation saved to ``translation.json`` (``:380-398,457-466``).

Eval mode reproduces the fork's time-ordered split (``:97-168``): select one
recording every 5 along the time ordering; when one of the next 4 recordings
jumps > 2 m the run is cut and restarts there; between selected train
recordings, the 3rd recording joins the test set with probability 0.35.
``test.txt`` lists the test recordings' per-face image names.
"""

from __future__ import annotations

import json
import math
import random
from pathlib import Path

import numpy as np

from ..data import colmap

FACE_YAW = {"f1": 0, "f2": 45, "r1": 90, "r2": 135, "b1": 180, "b2": 225,
            "l1": 270, "l2": 315, "u1": 90, "u2": 270}
FACE_PITCH = {"f1": 0, "f2": 0, "r1": 0, "r2": 0, "b1": 0, "b2": 0,
              "l1": 0, "l2": 0, "u1": -45, "u2": -45}
DEFAULT_FACES = ("f1", "f2", "r1", "r2", "b1", "b2", "l1", "l2")


def face_intrinsics(cube_face_size: int):
    """PINHOLE params for a 90°-FOV cube face (f = size/2, centered pp)."""
    f = cube_face_size / 2.0
    c = cube_face_size / 2.0
    return np.array([f, f, c, c], np.float64)


def face_rotation(face: str, vehicle_direction: float,
                  yaw: float) -> np.ndarray:
    """World→camera rotation for a cube face (R = R_x(90°+pitch) ·
    R_z(yaw + vehicle_dir + face_yaw), reference ``compute_extrinsics``)."""
    yaw_r = math.radians(yaw + vehicle_direction + FACE_YAW[face])
    pitch_r = math.radians(90 + FACE_PITCH[face])
    rx = np.array([[1, 0, 0],
                   [0, math.cos(pitch_r), -math.sin(pitch_r)],
                   [0, math.sin(pitch_r), math.cos(pitch_r)]])
    rz = np.array([[math.cos(yaw_r), -math.sin(yaw_r), 0],
                   [math.sin(yaw_r), math.cos(yaw_r), 0],
                   [0, 0, 1]])
    return rx @ rz


def select_eval_images(records: list[dict], seed: int = 0):
    """Time-ordered 1-in-5 selection with the 2 m distance-reset rule and
    35 %-sampled test picks.  Returns (train_ids, colmap_ids, test_ids)."""
    rng = np.random.default_rng(seed)
    train, all_ids, test = [], [], []
    i = 0
    n = len(records)
    while i < n:
        rec = records[i]
        train.append(rec["ImageId"])
        all_ids.append(rec["ImageId"])
        reset = False
        next_i = i + 5
        cx, cy = rec["X"], rec["Y"]
        for j in range(1, 5):
            if i + j >= n:
                break
            nxt = records[i + j]
            d = math.hypot(nxt["X"] - cx, nxt["Y"] - cy)
            if d > 2.0:
                reset = True
                next_i = i + j
                break
            cx, cy = nxt["X"], nxt["Y"]
        if not reset and i + 2 < n and rng.random() < 0.35:
            test_rec = records[i + 2]
            test.append(test_rec["ImageId"])
            all_ids.append(test_rec["ImageId"])
        i = next_i
    return train, all_ids, test


def generate_colmap_from_calibration(
    recording_details: str | Path | dict,
    output_sparse: str | Path,
    cube_face_size: int = 2048,
    faces=DEFAULT_FACES,
    eval_mode: bool = False,
    seed: int = 0,
):
    """Write cameras/images(/empty points3D) + translation.json (+ test.txt
    in eval mode).  Image names follow the rectified layout
    ``cam<face-index+1>/<ImageId>.jpg`` (one pinhole camera per face)."""
    if not isinstance(recording_details, dict):
        recording_details = json.loads(Path(recording_details).read_text())
    records = sorted(recording_details["RecordingProperties"],
                     key=lambda r: r.get("RecordedAt", r["ImageId"]))

    if eval_mode:
        train_ids, keep_ids, test_ids = select_eval_images(records, seed)
    else:
        keep_ids = [r["ImageId"] for r in records]
        train_ids, test_ids = list(keep_ids), []
    keep = set(keep_ids)
    records = [r for r in records if r["ImageId"] in keep]

    x_c = sum(r["X"] for r in records) / len(records)
    y_c = sum(r["Y"] for r in records) / len(records)

    cams = {}
    for fi, face in enumerate(faces):
        cams[fi + 1] = colmap.ColmapCamera(
            fi + 1, "PINHOLE", cube_face_size, cube_face_size,
            face_intrinsics(cube_face_size))

    images = {}
    iid = 1
    test_names = []
    for rec in records:
        pos = np.array([rec["X"] - x_c, rec["Y"] - y_c,
                        rec.get("Height", rec.get("Z", 0.0))], np.float64)
        for fi, face in enumerate(faces):
            R = face_rotation(face, rec.get("VehicleDirection", 0.0),
                              rec.get("Yaw", 0.0))
            t = -R @ pos
            name = f"cam{fi + 1}/{rec['ImageId']}.jpg"
            images[iid] = colmap.ColmapImage(
                iid, colmap.rotmat2qvec(R), t, fi + 1, name,
                np.zeros((0, 2)), np.zeros(0, np.int64))
            if rec["ImageId"] in test_ids:
                test_names.append(name)
            iid += 1

    out = Path(output_sparse)
    out.mkdir(parents=True, exist_ok=True)
    pts = colmap.ColmapPoints(
        xyz=np.zeros((0, 3)), rgb=np.zeros((0, 3), np.uint8),
        error=np.zeros(0), ids=np.zeros(0, np.int64))
    colmap.write_model(cams, images, pts, out)
    (out / "translation.json").write_text(
        json.dumps({"x_translation": x_c, "y_translation": y_c}))
    if eval_mode:
        (out / "test.txt").write_text("\n".join(test_names) + "\n")
    return {"n_recordings": len(records), "n_images": len(images),
            "n_test": len(test_names), "translation": (x_c, y_c)}
