"""3D covariance construction and EWA 2D projection, mirroring
``street_sparse_3dgs_tpu/core/covariance.py`` (Σ = R S Sᵀ Rᵀ, Σ' = J W Σ
Wᵀ Jᵀ plus the 0.3-pixel low-pass dilation), elementwise in f32."""

from __future__ import annotations

import torch

from .quaternion import to_rotation_matrix

# Screen-space low-pass filter added to the projected covariance diagonal.
LOW_PASS = 0.3


def build_covariance(scales: torch.Tensor, quats: torch.Tensor,
                     scale_modifier: float = 1.0) -> torch.Tensor:
    """[..., 3] activated scales + [..., 4] quats -> [..., 3, 3] covariance."""
    R = to_rotation_matrix(quats)
    s = scales * scale_modifier
    M = R * s[..., None, :]
    return torch.matmul(M, M.transpose(-1, -2))


def camera_cov3d(scales: torch.Tensor, quats: torch.Tensor, W: torch.Tensor,
                 scale_modifier: float = 1.0) -> torch.Tensor:
    """Camera-space covariance W (R S Sᵀ Rᵀ) Wᵀ as [..., 3, 3], written out
    elementwise in the same order as the JAX reference.  ``W`` is the
    [3, 3] world->camera rotation, shared across the batch."""
    R = to_rotation_matrix(quats)
    s = scales * scale_modifier
    a = [[W[i, 0] * R[..., 0, j] * s[..., j]
          + W[i, 1] * R[..., 1, j] * s[..., j]
          + W[i, 2] * R[..., 2, j] * s[..., j]
          for j in range(3)] for i in range(3)]

    def dot(i, j):
        return a[i][0] * a[j][0] + a[i][1] * a[j][1] + a[i][2] * a[j][2]

    return torch.stack(
        [
            torch.stack([dot(0, 0), dot(0, 1), dot(0, 2)], dim=-1),
            torch.stack([dot(0, 1), dot(1, 1), dot(1, 2)], dim=-1),
            torch.stack([dot(0, 2), dot(1, 2), dot(2, 2)], dim=-1),
        ],
        dim=-2,
    )


def project_cov3d(cov3d: torch.Tensor, mean_cam: torch.Tensor,
                  focal_x, focal_y, tan_fovx, tan_fovy) -> torch.Tensor:
    """EWA projection of camera-space covariances [..., 3, 3] to packed 2D
    covariances [..., 3] = (cxx, cxy, cyy), low-pass term included."""
    tx, ty, tz = mean_cam[..., 0], mean_cam[..., 1], mean_cam[..., 2]
    lim_x = 1.3 * tan_fovx
    lim_y = 1.3 * tan_fovy
    tz_safe = torch.clamp(tz, min=1e-6)
    txz = torch.clamp(tx / tz_safe, -lim_x, lim_x) * tz_safe
    tyz = torch.clamp(ty / tz_safe, -lim_y, lim_y) * tz_safe

    inv_z = 1.0 / tz_safe
    inv_z2 = inv_z * inv_z
    j00 = focal_x * inv_z
    j02 = -focal_x * txz * inv_z2
    j11 = focal_y * inv_z
    j12 = -focal_y * tyz * inv_z2

    c = cov3d
    t00 = j00 * c[..., 0, 0] + j02 * c[..., 2, 0]
    t01 = j00 * c[..., 0, 1] + j02 * c[..., 2, 1]
    t02 = j00 * c[..., 0, 2] + j02 * c[..., 2, 2]
    t10 = j11 * c[..., 1, 0] + j12 * c[..., 2, 0]
    t11 = j11 * c[..., 1, 1] + j12 * c[..., 2, 1]
    t12 = j11 * c[..., 1, 2] + j12 * c[..., 2, 2]

    cxx = t00 * j00 + t02 * j02 + LOW_PASS
    cxy = t00 * 0.0 + t01 * j11 + t02 * j12
    cyy = t10 * 0.0 + t11 * j11 + t12 * j12 + LOW_PASS
    return torch.stack([cxx, cxy, cyy], dim=-1)


def conic_and_radius(cov2d: torch.Tensor):
    """Invert packed 2D covariances and bound their pixel footprint.

    Returns (conic [..., 3] = (a, b, c) of the inverse, radius [...] =
    ceil(3σ_max) in pixels, det [...])."""
    cxx, cxy, cyy = cov2d[..., 0], cov2d[..., 1], cov2d[..., 2]
    det = cxx * cyy - cxy * cxy
    det_safe = torch.where(det > 0.0, det, torch.ones_like(det))
    inv_det = 1.0 / det_safe
    conic = torch.stack([cyy * inv_det, -cxy * inv_det, cxx * inv_det], dim=-1)
    mid = 0.5 * (cxx + cyy)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda1 = mid + disc
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lambda1, min=0.0)))
    return conic, radius, det
