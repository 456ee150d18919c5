"""Quaternion math (wxyz convention), mirroring
``street_sparse_3dgs_tpu/core/quaternion.py``."""

from __future__ import annotations

import torch


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit-normalize quaternions along the last axis."""
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=eps)


def to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w,x,y,z) -> [..., 3, 3] rotation matrices. Normalizes first."""
    q = normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def align_sign(q: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Flip ``q`` where dot(q, ref) < 0 so that lerp interpolates the short
    way (hierarchy parent/child interpolation)."""
    dots = torch.sum(q * ref, dim=-1, keepdim=True)
    return torch.where(dots < 0.0, -q, q)
