"""Gaussian scene parameters, mirroring
``street_sparse_3dgs_tpu/models/gaussians.py``: the raw parameter tuple at
a fixed capacity with an ``active`` row mask, its static metadata, the
activations, initialisation from a point cloud (with the procedural skybox
dome and the scaffold ring), padding, the per-image exposure affines and
the big-Gaussian clamp.

Randomness goes in as tensors: the skybox dome's two uniform draws are an
argument of ``create_from_pcd``, so a test can hand it JAX's draws."""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import sh as shlib
from ..core.knn import mean_sq_dist_to_3nn_auto
from ..device import DEFAULT_DEVICE, resolve_device


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


# ---------------------------------------------------------------------------
# Construction


def _skybox_dome(uniform: torch.Tensor, center: torch.Tensor,
                 radius: float):
    """Procedural skybox: points on a partial sphere at 10x the scene
    radius, blue-tinted white (reference ``scene/gaussian_model.py:
    186-201``).  ``uniform`` [2, n] holds the two U[0, 1) draws: theta =
    2 pi u0, phi = arccos(1 - 1.4 u1)."""
    theta = 2.0 * math.pi * uniform[0]
    phi = torch.arccos(1.0 - 1.4 * uniform[1])
    r = 10.0 * radius
    xyz = torch.stack([r * torch.cos(theta) * torch.sin(phi),
                       r * torch.sin(theta) * torch.sin(phi),
                       r * torch.cos(phi)], dim=-1) + center
    color = torch.tensor([0.7, 0.8, 0.95], dtype=torch.float32,
                         device=xyz.device).expand(uniform.shape[1], 3)
    return xyz, color


def create_from_pcd(
    points: torch.Tensor,           # [N, 3]
    colors: torch.Tensor,           # [N, 3] in [0, 1]
    sh_degree: int = 3,
    skybox_points: int = 0,
    capacity: int | None = None,
    scaffold: GaussianParams | None = None,
    scaffold_skybox_points: int = 0,
    chunk_center: np.ndarray | None = None,
    chunk_extent: np.ndarray | None = None,
    skybox_locked: bool = False,
    skybox_uniform: torch.Tensor | None = None,
) -> tuple[GaussianParams, torch.Tensor, GaussianMeta]:
    """Initialise the model from a point cloud on ``points``' device.
    Returns (params, active [C], meta), as the JAX function.  With
    ``skybox_points > 0`` (and no scaffold) ``skybox_uniform`` [2,
    skybox_points] gives the dome's uniform draws.  With ``scaffold`` the
    skybox is inherited from it and a ring of scaffold rows around the
    chunk bounds is prepended."""
    pts = points.to(torch.float32)
    cols = colors.to(torch.float32).to(pts.device)
    dev = pts.device
    lo = torch.min(pts, dim=0).values
    hi = torch.max(pts, dim=0).values
    center = 0.5 * (lo + hi)
    radius = float(torch.linalg.norm(hi - center))

    use_skybox = skybox_points > 0 and scaffold is None
    if use_skybox:
        if skybox_uniform is None or \
                tuple(skybox_uniform.shape) != (2, skybox_points):
            raise ValueError("create_from_pcd: the skybox needs "
                             f"skybox_uniform of shape (2, {skybox_points})")
        sky_xyz, sky_col = _skybox_dome(skybox_uniform.to(dev), center,
                                        radius)
        xyz = torch.cat([sky_xyz, pts])
        color = torch.cat([sky_col, cols])
    else:
        skybox_points = 0
        xyz, color = pts, cols
    n = xyz.shape[0]

    # Scale init: log sqrt of the mean squared 3-NN distance.
    dist2 = torch.clamp(mean_sq_dist_to_3nn_auto(xyz), min=1e-7)
    if use_skybox:
        sky = torch.arange(n, device=dev) < skybox_points
        dist2 = torch.where(sky, dist2 * 10.0, torch.clamp(dist2, max=10.0))
    log_scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    quats = torch.zeros((n, 4), device=dev)
    quats[:, 0] = 1.0
    if use_skybox:
        opacity = inverse_sigmoid(0.02 * torch.ones((n, 1), device=dev))
        opacity[:skybox_points] = 0.7     # raw logit, as the reference
    else:
        opacity = inverse_sigmoid(0.01 * torch.ones((n, 1), device=dev))
    k_rest = (sh_degree + 1) ** 2 - 1
    params = GaussianParams(xyz, shlib.rgb_to_sh(color)[:, None, :],
                            torch.zeros((n, k_rest, 3), device=dev),
                            log_scales, quats, opacity)

    scaffold_count = 0
    if scaffold is not None:
        ring, scaffold_count = select_scaffold_ring(
            scaffold, scaffold_skybox_points, np.asarray(chunk_center),
            np.asarray(chunk_extent))
        params = GaussianParams(*(torch.cat([a.to(dev), b])
                                  for a, b in zip(ring, params)))
        n += scaffold_count
        skybox_points = min(scaffold_skybox_points, scaffold_count)

    if capacity is None:
        capacity = n
    params, active = pad_to_capacity(params, n, capacity)
    meta = GaussianMeta(sh_degree=sh_degree, capacity=capacity,
                        skybox_points=skybox_points,
                        scaffold_points=scaffold_count,
                        skybox_locked=skybox_locked)
    return params, active, meta


def select_scaffold_ring(scaffold: GaussianParams, skybox_points: int,
                         center: np.ndarray, extent: np.ndarray):
    """Scaffold rows kept for a chunk: the skybox head plus the points in a
    square ring 0.5-1.5 chunk extents from the chunk centre (reference
    ``scene/gaussian_model.py:249-257``).  Returns (rows, count)."""
    xyz = scaffold.xyz.detach().cpu().numpy()
    d = np.abs(xyz - np.asarray(center))
    m = np.maximum(d[:, 0], d[:, 1])
    selec = (m > 0.5 * extent[0]) & (m < 1.5 * extent[0])
    selec[:skybox_points] = True
    idx = torch.as_tensor(np.nonzero(selec)[0], device=scaffold.xyz.device)
    return GaussianParams(*(a[idx] for a in scaffold)), int(idx.numel())


def pad_to_capacity(params: GaussianParams, n_active: int, capacity: int):
    """Pad every leaf to ``capacity`` rows of inactive padding (zero
    opacity, unit quaternion, tiny scale at the origin)."""
    if capacity < n_active:
        raise ValueError(f"capacity {capacity} < active rows {n_active}")
    n = params.xyz.shape[0]
    pad = capacity - n

    def pad_leaf(a, fill=0.0):
        if pad == 0:
            return a
        return torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), fill,
                                        dtype=a.dtype, device=a.device)])

    quats = pad_leaf(params.quats)
    if pad:
        quats[n:, 0] = 1.0
    padded = GaussianParams(
        xyz=pad_leaf(params.xyz),
        features_dc=pad_leaf(params.features_dc),
        features_rest=pad_leaf(params.features_rest),
        log_scales=pad_leaf(params.log_scales, -10.0),
        quats=quats,
        opacity_raw=pad_leaf(params.opacity_raw, -10.0))
    active = torch.arange(capacity, device=params.xyz.device) < n_active
    return padded, active


def frozen_mask(meta: GaussianMeta, capacity: int,
                device: torch.device | str = DEFAULT_DEVICE) -> torch.Tensor:
    """[C] rows whose grads the training loops zero: the scaffold block in
    chunk training or the locked skybox."""
    n = meta.scaffold_points if meta.scaffold_points > 0 else (
        meta.skybox_points if meta.skybox_locked else 0)
    return torch.arange(capacity, device=resolve_device(device)) < n


# ---------------------------------------------------------------------------
# Exposure


def init_exposure(n_images: int,
                  device: torch.device | str = DEFAULT_DEVICE
                  ) -> torch.Tensor:
    """[n_images, 3, 4] identity affine colour transforms."""
    eye = torch.eye(3, 4, dtype=torch.float32, device=resolve_device(device))
    return eye.expand(n_images, 3, 4).clone()


def apply_exposure(image: torch.Tensor, exposure: torch.Tensor) -> torch.Tensor:
    """A 3x4 affine on a [3, H, W] image (``img_hwc @ E[:3, :3]`` plus the
    translation column, reference ``gaussian_renderer/__init__.py:
    115-118``), as three exact f32 products per output channel."""
    e = exposure[:, :3]
    out = (e[0][:, None, None] * image[0] + e[1][:, None, None] * image[1]
           + e[2][:, None, None] * image[2])
    return out + exposure[:, 3, None, None]


# ---------------------------------------------------------------------------
# Big-Gaussian clamp


def clamp_big_gaussians(params: GaussianParams, meta: GaussianMeta,
                        extent: float, fraction: float,
                        active: torch.Tensor) -> GaussianParams:
    """Shrink Gaussians whose max scale exceeds ``fraction * extent`` by
    x0.8, excluding the frozen leading block (``train_single.py:235-241``)."""
    scales = torch.exp(params.log_scales)
    violators = torch.max(scales, dim=1).values > fraction * extent
    n_skip = meta.scaffold_points if meta.scaffold_points > 0 \
        else meta.skybox_points
    rows = torch.arange(scales.shape[0], device=scales.device)
    violators = violators & (rows >= n_skip) & active
    new_log = torch.where(violators[:, None],
                          params.log_scales + math.log(0.8),
                          params.log_scales)
    return params._replace(log_scales=new_log)
