"""Frozen counts of the work an image needs, for the rooflines and the
MFU figures: whatever kernel implements it, a blend needs only the
Gaussians that pass the 1/255 alpha test at a pixel before its
transmittance falls under 1e-4 (counted by the plain reference for the
inputs the kernel was given), each input read once and each output
written once.

Peaks: one NVIDIA H100 SXM, data sheet, dense, at the 700 W power limit:
67 TFLOP/s float32 outside the tensor cores (TF32 is off) and 3.35 TB/s
of HBM3.  A card set to a lower limit runs below them.
"""

from __future__ import annotations

import torch

from . import raster

PEAK_FLOP_S = 67e12
PEAK_BYTES_S = 3.35e12
ATTR_FLOATS = 10       # mean2d 2, conic 3, colour 3, opacity 1, inv depth 1
PIXEL_FLOATS = 5       # colour 3, inv depth 1, alpha (or final T) 1
FWD_OPS = 15 + 3       # a passing step: 15 f32 operations, 3 special results
BWD_OPS = 50           # a passing step of the backward walk, f32
PROJ_FWD_OPS = 350     # a visible row: transforms, EWA covariance, SH deg 3
PROJ_BWD_OPS = 700     # its backward
ADAM_OPS = 12          # a parameter element of a masked Adam step


def blend_fwd_bound_s(passes: int, visible: int, height: int,
                      width: int) -> float:
    bytes_ = 4 * (ATTR_FLOATS * visible + PIXEL_FLOATS * height * width)
    return max(FWD_OPS * passes / PEAK_FLOP_S, bytes_ / PEAK_BYTES_S)


def blend_bwd_bound_s(passes: int, visible: int, height: int,
                      width: int) -> float:
    # Reads the rows and the image's cotangents and final state, writes
    # each row's ten gradients.
    bytes_ = 4 * (2 * ATTR_FLOATS * visible + PIXEL_FLOATS * height * width)
    return max(BWD_OPS * passes / PEAK_FLOP_S, bytes_ / PEAK_BYTES_S)


def train_step_ops(passes: int, visible: int, param_elems: int) -> float:
    return ((FWD_OPS + BWD_OPS) * passes
            + (PROJ_FWD_OPS + PROJ_BWD_OPS) * visible
            + ADAM_OPS * param_elems)


def serve_frame_ops(passes: int, visible: int) -> float:
    return FWD_OPS * passes + PROJ_FWD_OPS * visible


def count_passes(means, scales, quats, opacities, shs, cam: dict,
                 sh_degree: int, bg) -> dict:
    """Passing steps and visible rows of one view."""
    with torch.no_grad():
        p = raster.project(means, scales, quats, opacities, shs, cam,
                           sh_degree)
        plan = raster.plan_tiles(p, cam["height"], cam["width"])
        _, _, _, passes = raster.render(plan, raster.attrs_of(p), bg)
    return {"passes": passes, "visible": int(p.valid.sum()),
            "height": cam["height"], "width": cam["width"]}
