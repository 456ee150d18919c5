"""COLMAP SQLite database writer — ``preprocess/fill_database.py`` /
``database.py`` equivalents.

Creates a database with the public COLMAP schema and fills the cameras and
images tables from a sparse model, so ``colmap feature_extractor`` can run
with known intrinsics/poses (the cal_sfm workflow,
``preprocess/generate_colmap.py:163-290``).
"""

from __future__ import annotations

import sqlite3
from pathlib import Path

import numpy as np

from ..data import colmap

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL, width INTEGER NOT NULL,
    height INTEGER NOT NULL, params BLOB, prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE, camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL);
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL, F BLOB, E BLOB, H BLOB,
    qvec BLOB, tvec BLOB);
"""


def fill_database(db_path: str | Path, cams: dict[int, colmap.ColmapCamera],
                  images: dict[int, colmap.ColmapImage]) -> None:
    db = sqlite3.connect(str(db_path))
    try:
        db.executescript(_SCHEMA)
        for cam in cams.values():
            model_id = colmap.CAMERA_MODEL_IDS[cam.model]
            params = np.asarray(cam.params, np.float64).tobytes()
            db.execute(
                "INSERT INTO cameras (camera_id, model, width, height, "
                "params, prior_focal_length) VALUES (?, ?, ?, ?, ?, 1)",
                (cam.id, model_id, cam.width, cam.height, params))
        for im in images.values():
            db.execute(
                "INSERT INTO images (image_id, name, camera_id, prior_qw, "
                "prior_qx, prior_qy, prior_qz, prior_tx, prior_ty, prior_tz)"
                " VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
                (im.id, im.name, im.camera_id, *[float(v) for v in im.qvec],
                 *[float(v) for v in im.tvec]))
        db.commit()
    finally:
        db.close()


def read_database_images(db_path: str | Path) -> dict[int, str]:
    db = sqlite3.connect(str(db_path))
    try:
        return {row[0]: row[1]
                for row in db.execute("SELECT image_id, name FROM images")}
    finally:
        db.close()
