"""Views served from the LOD hierarchy, one closed-loop viewer client: per
frame the port's ``hierarchy.structure.select_cut`` at the mix's
granularity tau, then ``hierarchy.render.render_cut_compact`` (through
``ops.rasterize.rasterize`` under the configuration's exact
``RasterConfig``).  A frame's latency runs from its request to the
rendered float frame [3, H, W] on the card, synchronised; the viewer's
conversion to uint8 on the host and its encoding are not timed here.

The check renders a sample of the window's frames, drawn from the seed,
with the plain reference from the same hierarchy and cameras, and
compares both frames after the same uint8 conversion (clamp, x255,
truncate: the viewer's), once the window has closed.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import scene
from ..reference import raster
from ..reference.train import LEAVES
from ..traffic import Traffic
from .train_chunk import camera_params, raster_settings


def make_hierarchy(cfg: dict, seed: int, device) -> dict:
    g = scene.generator(seed, device)
    rows = scene.street_rows(g, cfg["n_leaves"], cfg["sh_degree"],
                             cfg["length"], cfg["half_width"], device,
                             cfg.get("regular_objects", False))
    return scene.build_hierarchy(rows)


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.traffic = Traffic(mix, seed)
        self.bg = torch.zeros(3, device=device)
        self.i_window = 0
        rng = np.random.default_rng(int(seed) + 1)
        self.sample = sorted(int(x) for x in rng.choice(
            mix["sample_below"], mix["check_frames"], replace=False))

    def _camera(self, i: int) -> dict:
        r = self.traffic[i]
        return scene.camera(r["pos"], r["yaw"], r["pitch"], self.cfg["width"],
                            self.cfg["height"], self.mix["fovx_deg"])

    def setup(self) -> None:
        from street_sparse_3dgs_tpu_torch.core.camera import CameraParams
        from street_sparse_3dgs_tpu_torch.hierarchy import render, structure
        from street_sparse_3dgs_tpu_torch.models.gaussians import \
            GaussianParams
        from street_sparse_3dgs_tpu_torch.ops.rasterize import RasterConfig

        dev = self.device
        h = make_hierarchy(self.cfg, self.seed, dev)
        self.n_nodes = int(h["parent"].shape[0])
        self.depth = h["depth"]
        self.hier = structure.Hierarchy(
            params=GaussianParams(*(h[k] for k in LEAVES)),
            parent=h["parent"], child_start=h["child_start"],
            child_count=h["child_count"], box_center=h["box_center"],
            box_half=h["box_half"], size=h["size"],
            anchors=torch.zeros(self.n_nodes, dtype=torch.bool, device=dev),
            skybox_count=0)
        del h
        r = raster_settings(self.cfg)
        self.rcfg = RasterConfig(
            method=r["raster_method"], max_dup=r["max_dup"],
            tile_capacity=r["tile_capacity"], exact_extra=r["exact_extra"],
            dup_overscan=r["dup_overscan"], dup_tails=r["dup_tails"],
            grad_reduce=r["grad_reduce"], grad_sort=r["grad_sort"])
        self._port = (CameraParams, structure, render)
        # Warm-up frames spread over the first ``warmup_span`` frames, so
        # that the largest cuts the window will render are allocated before
        # it: the window then starts again at the first frame.
        self.frames = {}
        self.i = 0
        self.begin_window()
        n, span = self.mix["warmup_frames"], self.mix["warmup_span"]
        for k in range(n):
            self.i = k * span // n
            self.request()
        self.i = 0
        self.frames = {}

    def request(self):
        # The port's functions are looked up at each call, so that a trace
        # can place its spans around them.
        CameraParams, structure, render = self._port
        i = self.i
        self.i += 1
        cam = self._camera(i)
        cp = camera_params(CameraParams, cam, self.device)
        limit = structure.pixel_limit(self.mix["tau"], float(cam["tan_fovx"]),
                            cam["width"])
        with torch.no_grad():
            cut = structure.select_cut(self.hier, cp.campos, limit)
            out = render.render_cut_compact(self.hier.params, cut, self.n_nodes,
                                     self.hier.skybox_count, cp, 3, self.bg,
                                     self.rcfg)
        rows = int(out["radii"].shape[0])
        self.rows[rows] = self.rows.get(rows, 0) + 1
        over = torch.stack([out["dup_overflow"], out["tile_overflow"]])
        self.overflow = torch.maximum(self.overflow, over)
        if i - self.i_window in self.sample:
            self.frames[i] = out["render"].clone()
        return out["render"]

    def begin_window(self) -> None:
        self.i_window = self.i
        self.rows = {}
        self.overflow = torch.zeros(2, dtype=torch.int64, device=self.device)

    def snapshot(self) -> dict:
        return {"frame": self.i}

    def count(self, snap: dict) -> dict:
        """The work of frame ``snap`` for the rooflines and the MFU, from
        the reference's own cut of the served hierarchy."""
        h = dict(zip(LEAVES, self.hier.params), parent=self.hier.parent,
                 child_count=self.hier.child_count,
                 box_center=self.hier.box_center,
                 box_half=self.hier.box_half, size=self.hier.size)
        cam = self._camera(snap["frame"])
        _, passes, visible = reference_frame(h, cam, self.mix["tau"], self.bg)
        return {"passes": passes, "visible": visible,
                "height": cam["height"], "width": cam["width"]}

    def describe(self) -> dict:
        """The tree, and the window's frames by the padded row count the
        compacted cut handed to the rasterizer."""
        return {"hierarchy_nodes": self.n_nodes, "hierarchy_depth": self.depth,
                "frames_by_rows": self.rows}

    def counters(self) -> dict:
        dup, tile = (int(x) for x in self.overflow.tolist())
        return {"dup_overflow": dup, "tile_overflow": tile, "failed": 0}

    def end_to_end(self, latencies: list, window_s: float) -> dict:
        lat = sorted(latencies)
        return {"frame_ms_p95": percentile(lat, 95) * 1e3,
                "frames_per_s": len(lat) / window_s}

    def release(self) -> None:
        self.hier = None
        self.frames = {}

    # -- the check ----------------------------------------------------------
    def program_outputs(self) -> dict:
        return {"frames": {i: raster.frame_uint8(f).cpu().numpy()
                           for i, f in self.frames.items()}}

    def reference_outputs(self, tf32: bool = False) -> dict:
        h = make_hierarchy(self.cfg, self.seed, self.device)
        frames = {}
        for i in (self.i_window + s for s in self.sample):
            frames[i] = reference_frame(h, self._camera(i), self.mix["tau"],
                                        self.bg, tf32)[0].cpu().numpy()
        return {"frames": frames}

    def compare(self, prog: dict, ref: dict, limits: dict) -> list:
        return compare_frames(prog, ref, limits)

    def summary(self, prog: dict, ref: dict) -> dict:
        """Each sampled frame's share of values off by more than a level."""
        return {str(i): compare_frames({"frames": {i: prog["frames"][i]}},
                                       {"frames": {i: r}},
                                       {"frame_off_share": 0})[0][1]
                for i, r in ref["frames"].items() if i in prog["frames"]}


def reference_frame(h: dict, cam: dict, tau: float, bg, tf32: bool = False):
    """(uint8 frame [H, W, 3], passing Gaussians, projected rows kept)."""
    raster.full_precision()
    limit = raster.pixel_limit(tau, cam["tan_fovx"], cam["width"])
    with torch.no_grad():
        rows = raster.cut_rows(h, cam["campos"], limit)
        p = raster.project(*rows, cam, 3, tf32)
        plan = raster.plan_tiles(p, cam["height"], cam["width"])
        img, _, _, passes = raster.render(plan, raster.attrs_of(p), bg, tf32)
    return raster.frame_uint8(img), passes, int(p.valid.sum())


def compare_frames(prog: dict, ref: dict, limits: dict) -> list:
    """[(name, value, limit)]: the share of a frame's channel values that
    differ from the reference's by more than one level, by the worst
    sampled frame, and the frames that never came (the sample drawn
    below the window's frame count)."""
    worst, missing = 0.0, 0
    for i, r in ref["frames"].items():
        p = prog["frames"].get(i)
        if p is None:
            missing += 1
            continue
        off = np.abs(p.astype(np.int16) - r.astype(np.int16)) > 1
        worst = max(worst, float(off.mean()))
    return [("frame_off_share", worst, limits["frame_off_share"]),
            ("frames_missing", float(missing), 0.0)]


def percentile(sorted_vals: list, q: float) -> float:
    """Linear interpolation between the two nearest ranks."""
    pos = (len(sorted_vals) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * (pos - lo)
