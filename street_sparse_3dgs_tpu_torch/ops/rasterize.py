"""Public rasterization API, mirroring ``street_sparse_3dgs_tpu/ops/
rasterize.py``:

    rasterize(means3D, scales, rotations, opacities, shs, camera, ...) ->
        {render [3,H,W], depth [1,H,W], alpha [H,W], radii [N],
         visibility [N], dup_overflow, tile_overflow, vis_overflow}

``RasterConfig`` has the same fields, defaults and method names as the JAX
one, so a JAX config means the same thing here.  ``method="pallas"`` — the
name kept from the JAX package, where it selects the Pallas TPU kernels —
selects this port's hand-written CUDA kernels: K5 builds the tile tables,
K1 (padded) or K3 (``exact_extra > 0``) blends them, and their backwards
K2 / K4 run under autograd, on CUDA tensors.  ``grad_reduce`` and
``grad_sort`` shape the slot->Gaussian reduction of the backward
(``cuda_blend.slot_grads_to_rows``): ``"counts"`` takes its segments from
binning's ``seg_pos`` and is sound only at ``tile_overflow == 0``.

Every method is differentiable with respect to the Gaussian rows, ``bg``
and ``mean2d_residual``: pass zeros [N, 2] with ``requires_grad`` and read
its grad for the screen-space position gradients densification needs.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.camera import CameraParams
from .binning import bin_gaussians, num_tiles
from .blend import blend_tiles
from .cuda_blend import blend_tiles_pallas
from .oracle import render_oracle
from .preprocess import project_gaussians


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Static rasterizer knobs (field for field the JAX ``RasterConfig``)."""

    method: str = "tiled"        # "tiled" | "oracle" | "pallas" (CUDA kernels)
    max_dup: int = 64            # per-Gaussian tile-coverage cap
    tile_capacity: int = 512     # per-tile Gaussian cap (K)
    tiles_chunk: int = 16        # tiles blended per step of the tiled method
    attr_dtype: str = "f32"      # "f32" | "bf16" (pallas method only)
    vis_capacity: int | None = None
    grad_sort: str = "f32"       # "f32" | "bf16" (backward slot reduction)
    tile_batch: int = 0          # TPU program batching (no effect here)
    exact_extra: int = 0         # extra K-wide windows (exact mode when > 0)
    grad_reduce: str = "sort"    # "sort" | "counts" (backward segments)
    dup_overscan: int = 0
    dup_tails: tuple = ()


def bin_kwargs(config: RasterConfig, exact_extra: int = 0,
               exact_shards: int = 1) -> dict:
    """The binning knobs of ``config`` as ``bin_gaussians`` keywords; exact
    mode with ``exact_extra`` windows over ``exact_shards`` segments."""
    kw = dict(vis_capacity=config.vis_capacity,
              dup_overscan=config.dup_overscan)
    if config.dup_tails:
        kw["dup_tails"] = config.dup_tails
    if exact_extra:
        kw.update(exact_extra=exact_extra, exact_shards=exact_shards,
                  with_seg_pos=config.grad_reduce == "counts")
    return kw


def attr_dtype(config: RasterConfig) -> torch.dtype:
    """The dtype the blend packs its attributes in."""
    return torch.bfloat16 if config.attr_dtype == "bf16" else torch.float32


def rasterize(
    means3d: torch.Tensor,        # [N, 3]
    scales: torch.Tensor,         # [N, 3] activated
    quats: torch.Tensor,          # [N, 4]
    opacities: torch.Tensor,      # [N] activated
    sh_coeffs: torch.Tensor,      # [N, K, 3]
    camera: CameraParams,
    sh_degree: int,
    bg: torch.Tensor,             # [3]
    config: RasterConfig = RasterConfig(),
    scale_modifier: float = 1.0,
    active_mask: torch.Tensor | None = None,
    mean2d_residual: torch.Tensor | None = None,
    colors_precomp: torch.Tensor | None = None,
):
    proj = project_gaussians(means3d, scales, quats, opacities, sh_coeffs,
                             camera, sh_degree, scale_modifier, active_mask)
    if colors_precomp is not None:
        proj = proj._replace(color=colors_precomp)
    if mean2d_residual is not None:
        proj = proj._replace(mean2d=proj.mean2d + mean2d_residual)

    h, w = camera.height, camera.width
    out = {"radii": proj.radius, "visibility": proj.valid}
    zero = torch.zeros((), dtype=torch.int64, device=means3d.device)

    if config.method == "oracle":
        image, invdepth, alpha = render_oracle(
            proj, h, w, bg, tile_grid=num_tiles(h, w))
        out["dup_overflow"] = zero
        out["tile_overflow"] = zero
        out["vis_overflow"] = zero
    elif config.method == "tiled":
        bins = bin_gaussians(proj, h, w, config.max_dup, config.tile_capacity,
                             vis_capacity=config.vis_capacity)
        image, invdepth, alpha = blend_tiles(
            bins, proj.mean2d, proj.conic, proj.color,
            proj.opacity, proj.inv_depth, h, w, bg,
            tiles_chunk=config.tiles_chunk)
        out["dup_overflow"] = bins.dup_overflow
        out["tile_overflow"] = bins.tile_overflow
        out["vis_overflow"] = bins.vis_overflow
    elif config.method == "pallas":
        if config.grad_reduce == "counts" and not config.exact_extra:
            raise ValueError("grad_reduce='counts' requires exact mode "
                             "(exact_extra > 0)")
        bins = bin_gaussians(proj, h, w, config.max_dup,
                             config.tile_capacity,
                             **bin_kwargs(config, config.exact_extra))
        image, invdepth, alpha = blend_tiles_pallas(
            bins, proj.mean2d, proj.conic, proj.color,
            proj.opacity, proj.inv_depth, h, w, bg,
            grad_sort=config.grad_sort, tile_batch=config.tile_batch,
            attr_dtype=attr_dtype(config))
        out["dup_overflow"] = bins.dup_overflow
        out["tile_overflow"] = bins.tile_overflow
        out["vis_overflow"] = bins.vis_overflow
    else:
        raise ValueError(f"unknown raster method {config.method!r}")

    out["render"] = image
    out["depth"] = invdepth
    out["alpha"] = alpha
    return out
