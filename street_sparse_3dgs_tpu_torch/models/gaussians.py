"""Gaussian scene parameters, mirroring the render-side part of
``street_sparse_3dgs_tpu/models/gaussians.py``: the raw parameter tuple,
its static metadata and the activations.  Initialisation, the skybox and
exposure belong to the training slice."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


class GaussianParams(NamedTuple):
    """Raw (pre-activation) per-Gaussian parameters, one row per slot."""

    xyz: torch.Tensor            # [C, 3]
    features_dc: torch.Tensor    # [C, 1, 3]
    features_rest: torch.Tensor  # [C, K-1, 3]
    log_scales: torch.Tensor     # [C, 3]
    quats: torch.Tensor          # [C, 4] wxyz
    opacity_raw: torch.Tensor    # [C, 1] logit (sigmoid mode) or raw (abs)


@dataclasses.dataclass(frozen=True)
class GaussianMeta:
    """Static model metadata (same fields as the JAX ``GaussianMeta``)."""

    sh_degree: int = 3
    capacity: int = 0
    skybox_points: int = 0
    scaffold_points: int = 0
    opacity_activation: str = "sigmoid"   # "sigmoid" | "abs" (hierarchy)
    skybox_locked: bool = False

    @property
    def n_frozen(self) -> int:
        return self.scaffold_points if self.scaffold_points > 0 else 0


def activate_scales(params: GaussianParams) -> torch.Tensor:
    return torch.exp(params.log_scales)


def activate_opacity(params: GaussianParams,
                     meta: GaussianMeta) -> torch.Tensor:
    """[C] activated opacity (sigmoid, or abs in hierarchy mode)."""
    raw = params.opacity_raw[:, 0]
    if meta.opacity_activation == "abs":
        return torch.abs(raw)
    return torch.sigmoid(raw)


def sh_coeffs(params: GaussianParams) -> torch.Tensor:
    """[C, K, 3] full SH coefficient stack (DC band first)."""
    return torch.cat([params.features_dc, params.features_rest], dim=1)
