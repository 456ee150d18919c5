"""Experiment management, the ``ss_utils/testManagementScripts``
equivalents (``save_test.py`` / ``load_test.py`` / ``remove_test.py`` /
``saveDataset.py`` / ``loadDataset.py``): the port's own copy of
``street_sparse_3dgs_tpu/pipeline/experiments.py`` (the same snapshot
layout and metadata file, so a store written by one package lists and
restores in the other).
"""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

SNAPSHOT_META = "snapshot_meta.json"


def _store(store_dir) -> Path:
    p = Path(store_dir)
    p.mkdir(parents=True, exist_ok=True)
    return p


def save_test(output_dir, store_dir, name: str,
              note: str = "") -> Path:
    """Snapshot a run's ``output`` directory under ``store/<name>``."""
    dst = _store(store_dir) / name
    if dst.exists():
        raise FileExistsError(f"snapshot {name!r} already exists")
    shutil.copytree(output_dir, dst)
    (dst / SNAPSHOT_META).write_text(json.dumps({
        "name": name, "note": note, "source": str(output_dir),
        "saved_at": time.time()}))
    return dst


def load_test(store_dir, name: str, output_dir) -> Path:
    """Restore snapshot ``name`` into ``output_dir`` (must not exist)."""
    src = _store(store_dir) / name
    if not src.exists():
        raise FileNotFoundError(f"no snapshot {name!r} in {store_dir}")
    dst = Path(output_dir)
    if dst.exists():
        raise FileExistsError(f"{output_dir} exists; remove it first")
    shutil.copytree(src, dst)
    meta = dst / SNAPSHOT_META
    if meta.exists():
        meta.unlink()
    return dst


def remove_test(store_dir, name: str) -> None:
    src = _store(store_dir) / name
    if not src.exists():
        raise FileNotFoundError(f"no snapshot {name!r} in {store_dir}")
    shutil.rmtree(src)


def list_tests(store_dir) -> list[dict]:
    out = []
    for d in sorted(_store(store_dir).iterdir()):
        meta = d / SNAPSHOT_META
        if meta.exists():
            out.append(json.loads(meta.read_text()))
        elif d.is_dir():
            out.append({"name": d.name, "note": "", "saved_at": None})
    return out


def save_dataset(project_dir, store_dir, name: str) -> Path:
    """Snapshot the preprocessed dataset (camera_calibration + rectified)."""
    dst = _store(store_dir) / name
    if dst.exists():
        raise FileExistsError(f"dataset snapshot {name!r} already exists")
    dst.mkdir(parents=True)
    for sub in ("camera_calibration", "rectified"):
        src = Path(project_dir) / sub
        if src.exists():
            shutil.copytree(src, dst / sub)
    (dst / SNAPSHOT_META).write_text(json.dumps({
        "name": name, "source": str(project_dir), "saved_at": time.time()}))
    return dst


def load_dataset(store_dir, name: str, project_dir) -> Path:
    src = _store(store_dir) / name
    if not src.exists():
        raise FileNotFoundError(f"no dataset snapshot {name!r}")
    proj = Path(project_dir)
    proj.mkdir(parents=True, exist_ok=True)
    for sub in ("camera_calibration", "rectified"):
        if (src / sub).exists():
            if (proj / sub).exists():
                raise FileExistsError(f"{proj / sub} exists")
            shutil.copytree(src / sub, proj / sub)
    return proj
