"""Per-Gaussian screen-space preprocessing, mirroring
``street_sparse_3dgs_tpu/ops/preprocess.py``: world->camera transform,
frustum cull, projection, EWA covariance, conic, pixel radius, SH->RGB.

All outputs are [N, ...] with a validity mask; culled rows get radius 0,
depth +inf, inverse depth 0 and opacity 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import sh as shlib
from ..core.camera import CameraParams, ndc_to_pixel
from ..core.covariance import camera_cov3d, conic_and_radius, project_cov3d
from ..profiling import span, sync_point

# Near-plane distance used for frustum culling.
NEAR_CULL = 0.2


class Projected(NamedTuple):
    """Screen-space Gaussian attributes, one row per (possibly culled) input."""

    mean2d: torch.Tensor     # [N, 2] pixel coordinates
    depth: torch.Tensor      # [N] camera-space z (+inf when culled)
    inv_depth: torch.Tensor  # [N] 1/z
    conic: torch.Tensor      # [N, 3] inverse 2D covariance (a, b, c)
    radius: torch.Tensor     # [N] pixel radius (0 => culled)
    color: torch.Tensor      # [N, 3] view-dependent RGB
    opacity: torch.Tensor    # [N] activated opacity
    valid: torch.Tensor      # [N] bool visibility mask


def project_gaussians(
    means3d: torch.Tensor,         # [N, 3]
    scales: torch.Tensor,          # [N, 3] activated scales
    quats: torch.Tensor,           # [N, 4] wxyz (normalized inside)
    opacities: torch.Tensor,       # [N] activated opacities
    sh_coeffs: torch.Tensor,       # [N, K, 3]
    camera: CameraParams,
    sh_degree: int,
    scale_modifier: float = 1.0,
    active_mask: torch.Tensor | None = None,
) -> Projected:
    with span("raster.project"):
        n = means3d.shape[0]
        ones = torch.ones((n, 1), dtype=means3d.dtype, device=means3d.device)
        hom = torch.cat([means3d, ones], dim=1)                 # [N, 4]

        # Full-f32 products (TF32 stays off: see chip_smoke.py's precision
        # check).
        p_view = hom @ camera.viewmatrix.T                      # [N, 4]
        depth = p_view[:, 2]

        p_clip = hom @ camera.projmatrix.T
        w = p_clip[:, 3]
        w_safe = torch.where(torch.abs(w) > 1e-7, w, torch.full_like(w, 1e-7))
        ndc = p_clip[:, :2] / w_safe[:, None]

        # A copy from pageable host memory: the host waits for the device.
        with sync_point("project_size"):
            size = torch.tensor([float(camera.width), float(camera.height)],
                                dtype=torch.float32, device=means3d.device)
        mean2d = ndc_to_pixel(ndc, size)

        cov_cam = camera_cov3d(scales, quats, camera.viewmatrix[:3, :3],
                               scale_modifier)
        cov2d = project_cov3d(cov_cam, p_view[:, :3],
                              camera.focal_x, camera.focal_y,
                              camera.tan_fovx, camera.tan_fovy)
        conic, radius, det = conic_and_radius(cov2d)

        valid = (depth > NEAR_CULL) & (det > 0.0)
        if active_mask is not None:
            valid = valid & active_mask
        in_image = (
            (mean2d[:, 0] + radius >= 0.0)
            & (mean2d[:, 0] - radius <= camera.width)
            & (mean2d[:, 1] + radius >= 0.0)
            & (mean2d[:, 1] - radius <= camera.height)
        )
        valid = valid & in_image & (radius > 0.0)

        color = shlib.sh_to_color(sh_degree, sh_coeffs, means3d, camera.campos)

        zero = torch.zeros_like(depth)
        radius = torch.where(valid, radius, zero)
        depth_safe = torch.clamp(depth, min=1e-6)
        return Projected(
            mean2d=mean2d,
            depth=torch.where(valid, depth,
                              torch.full_like(depth, float("inf"))),
            inv_depth=torch.where(valid, 1.0 / depth_safe, zero),
            conic=conic,
            radius=radius,
            color=color,
            opacity=torch.where(valid, opacities, zero),
            valid=valid,
        )
