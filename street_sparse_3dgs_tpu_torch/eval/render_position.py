"""Novel-view probe — the ``render_position.py`` equivalent, mirroring
``street_sparse_3dgs_tpu/eval/render_position.py``.

Groups the test cameras by (rounded) camera center, takes the first group
(e.g. all cube faces of one panorama recording), rigidly shifts the whole
group to a user-given (x, y[, z]) position by rebuilding the world-to-view
matrices, and renders each shifted view through the hierarchy on its device
(``render_position.py:20-99``: ``new_trans = target − center`` fed into
``getWorld2View2``'s translate argument; z defaults to the test cameras'
mean height).  The renders are written as PNGs through ``data/png.py``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..config import ModelConfig, PipelineConfig
from ..core.camera import make_camera
from ..data import png
from ..data.scene import load_scene_info, resolve_resolution
from ..hierarchy.render import render_cut
from ..hierarchy.structure import Hierarchy, pixel_limit, select_cut
from ..train.step import raster_config
from .render_hier import to_uint8


def group_cameras_by_center(infos, decimals: int = 2):
    groups: dict[tuple, list] = {}
    for info in infos:
        w2c = np.eye(4)
        w2c[:3, :3] = info.R.T
        w2c[:3, 3] = info.T
        center = np.linalg.inv(w2c)[:3, 3]
        key = tuple(np.round(center, decimals))
        groups.setdefault(key, []).append((info, center))
    return groups


def render_position(
    h: Hierarchy,
    scene_source: str,
    new_x: float | None,
    new_y: float | None,
    new_z: float | None = None,
    out_dir: str | Path = "position_renders",
    model_cfg: ModelConfig | None = None,
    pipe: PipelineConfig | None = None,
    tau: float = 0.0,
    sh_degree: int = 3,
    resolution: int = -1,
):
    """Render the first test-camera group shifted to (new_x, new_y, new_z).
    Returns the list of written files."""
    dev = h.params.xyz.device
    model_cfg = model_cfg or ModelConfig(eval=True)
    pipe = pipe or PipelineConfig()
    cfg = raster_config(pipe)
    info = load_scene_info(scene_source, model_cfg)
    cams = [c for c in (info.test_cameras or info.train_cameras)
            if not c.is_depth_only]
    groups = group_cameras_by_center(cams)
    groups = {k: v for k, v in sorted(groups.items())}
    key = next(iter(groups))
    group = groups[key]
    avg_z = float(np.mean([c[1][2] for cam_list in groups.values()
                           for c in cam_list]))

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for caminfo, center in group:
        if new_x is None or new_y is None:
            trans = np.zeros(3)
        else:
            tz = (avg_z if new_z is None else new_z) - center[2]
            trans = np.array([new_x - center[0], new_y - center[1], tz])
        w, hgt = resolve_resolution(caminfo.width, caminfo.height, resolution)
        cam = make_camera(caminfo.R, caminfo.T, caminfo.fovx, caminfo.fovy,
                          w, hgt, primx=caminfo.primx, primy=caminfo.primy,
                          translate=trans, device=dev)
        limit = pixel_limit(tau, float(cam.tan_fovx), cam.width)
        cut = select_cut(h, cam.campos, limit)
        with torch.no_grad():
            out = render_cut(h.params, cut, h.n_nodes, h.skybox_count, cam,
                             sh_degree, torch.zeros(3, device=dev), cfg)
        stem = caminfo.image_name.replace("/", "_").rsplit(".", 1)[0]
        path = out_dir / f"{stem}_shifted.png"
        png.write_png(path, to_uint8(torch.clamp(out["render"], 0, 1)))
        written.append(path)
    return written
