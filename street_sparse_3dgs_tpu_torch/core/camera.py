"""Camera math, mirroring ``street_sparse_3dgs_tpu/core/camera.py``.

Matrices act on column vectors: ``x_view = W2V @ [x; 1]``, ``x_clip = P @
x_view``.  ``world_to_view`` and ``projection_matrix`` stay in float64 numpy
and cast to float32 at the end, exactly as the JAX package does, so the
same (R, t, fov) give bit-identical camera matrices in both packages.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate=np.zeros(3), scale: float = 1.0) -> np.ndarray:
    """4x4 world->camera matrix from COLMAP-style (R, t); ``R`` is the
    camera-to-world rotation, ``t`` the world->camera translation."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    C2W[:3, 3] = (C2W[:3, 3] + translate) * scale
    return np.linalg.inv(C2W).astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float,
                      primx: float = 0.5, primy: float = 0.5) -> np.ndarray:
    """Perspective projection with off-center principal point (the frustum's
    sides split ``primx : 1-primx`` and ``primy : 1-primy``)."""
    tan_half_fovy = math.tan(fovy / 2.0)
    tan_half_fovx = math.tan(fovx / 2.0)

    top = tan_half_fovy * znear
    bottom = (1.0 - primy) * 2.0 * -top
    top = primy * 2.0 * top
    right = tan_half_fovx * znear
    left = (1.0 - primx) * 2.0 * -right
    right = primx * 2.0 * right

    P = np.zeros((4, 4), dtype=np.float64)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P.astype(np.float32)


class CameraParams(NamedTuple):
    """Per-view geometry consumed by the renderer: tensors plus the static
    image ``height``/``width`` (they fix output shapes and the tile grid)."""

    viewmatrix: torch.Tensor     # [4,4] world->camera
    projmatrix: torch.Tensor     # [4,4] full projection (P @ W2V)
    campos: torch.Tensor         # [3] camera center in world space
    tan_fovx: torch.Tensor       # scalar
    tan_fovy: torch.Tensor       # scalar
    focal_x: torch.Tensor        # scalar, pixels
    focal_y: torch.Tensor        # scalar, pixels
    height: int
    width: int


def make_camera(R: np.ndarray, t: np.ndarray, fovx: float, fovy: float,
                width: int, height: int, primx: float = 0.5,
                primy: float = 0.5, znear: float = 0.01, zfar: float = 100.0,
                translate=np.zeros(3), scale: float = 1.0,
                device: str | torch.device = DEFAULT_DEVICE) -> CameraParams:
    dev = resolve_device(device)
    w2v = world_to_view(R, t, translate, scale)
    proj = projection_matrix(znear, zfar, fovx, fovy, primx, primy) @ w2v
    campos = np.linalg.inv(w2v)[:3, 3]

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return CameraParams(
        viewmatrix=f32(w2v),
        projmatrix=f32(proj),
        campos=f32(campos),
        tan_fovx=f32(math.tan(fovx / 2.0)),
        tan_fovy=f32(math.tan(fovy / 2.0)),
        focal_x=f32(width / (2.0 * math.tan(fovx / 2.0))),
        focal_y=f32(height / (2.0 * math.tan(fovy / 2.0))),
        height=int(height),
        width=int(width),
    )


def ndc_to_pixel(ndc: torch.Tensor, size) -> torch.Tensor:
    """NDC [-1,1] -> pixel centers, 3DGS convention: ((ndc+1)·S - 1)/2."""
    return ((ndc + 1.0) * size - 1.0) * 0.5
