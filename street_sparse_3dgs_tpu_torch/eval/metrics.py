"""Evaluation metrics: PSNR / SSIM / LPIPS / iMAE / iRMSE, plain + masked,
mirroring ``street_sparse_3dgs_tpu/eval/metrics.py`` on the port's
``train/losses``.

Parity targets:
  - ``render_hierarchy.py:123-159``: PSNR/SSIM/LPIPS(vgg) on alpha-masked
    images, iMAE = Σ|Δinvdepth|/Σmask, iRMSE = sqrt(ΣΔ²/Σmask);
  - ``lpipsPyTorch/``: LPIPS with the fork's mask support (``eval/lpips``);
  - ``render_hierarchy_final.py:286-438``: per-semantic-category masked
    metrics from color-coded masks and depth-stratified bands with
    pixel-weighted aggregation.

Inputs are tensors (the metrics run on their device) or numpy arrays (on
the CPU); a mix runs on the device of the first tensor.  Scalars come back
as Python floats, masks as float32 tensors.  The SSIM window and LPIPS are
convolutions: run them with TF32 off on the card (the eval entry points do).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..train import losses

# Depth bands in meters (reference ``render_hierarchy_final.py:30-35``).
DEPTH_RANGES = (("near", 0.0, 5.0), ("medium", 5.0, 20.0),
                ("far", 20.0, float("inf")))


def _tensors(*xs):
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)),
               torch.device("cpu"))
    return [None if x is None else torch.as_tensor(
        np.asarray(x) if not isinstance(x, torch.Tensor) else x,
        device=dev) for x in xs]


def psnr(img, gt) -> float:
    return float(losses.psnr(*_tensors(img, gt)))


def ssim(img, gt) -> float:
    return float(losses.ssim(*_tensors(img, gt)))


def psnr_masked(img, gt, mask) -> float:
    return float(losses.psnr_masked(*_tensors(img, gt, mask)))


def ssim_masked(img, gt, mask) -> float:
    return float(losses.masked_ssim(*_tensors(img, gt, mask)))


def inverse_depth_errors(pred_invdepth, gt_invdepth, valid_mask):
    """(iMAE, iRMSE) with the reference's normalization: both maps are
    mask-multiplied and the error sums divide by the mask pixel count."""
    pred, gt, valid = _tensors(pred_invdepth, gt_invdepth, valid_mask)
    m = valid.to(torch.float32)
    p = pred * m
    g = gt * m
    denom = torch.clamp(torch.sum(m), min=1.0)
    imae = torch.sum(torch.abs(p - g)) / denom
    irmse = torch.sqrt(torch.sum((p - g) ** 2) / denom)
    return float(imae), float(irmse)


def lpips(img, gt, net_type: str = "vgg", mask=None) -> float:
    """LPIPS perceptual distance of two [3,H,W] images in [0,1]; with
    ``mask`` [1,H,W], the per-level distance maps are weighted by the
    downsampled mask (the fork's masked-LPIPS semantics,
    ``lpipsPyTorch/modules/lpips.py:32-60``).  See ``eval/lpips`` for the
    weights (``weights_kind()``)."""
    from . import lpips as _lpips

    return _lpips.lpips(img, gt, mask=mask)


def full_metrics(image, gt, alpha_mask=None, pred_invdepth=None,
                 gt_invdepth=None, with_lpips: bool = True) -> dict:
    """The per-view metric row of ``render_hierarchy.py`` evals."""
    image, gt, alpha_mask, pred_invdepth, gt_invdepth = _tensors(
        image, gt, alpha_mask, pred_invdepth, gt_invdepth)
    img = torch.clamp(image, 0, 1)
    g = torch.clamp(gt, 0, 1)
    if alpha_mask is not None:
        img = img * alpha_mask
        g = g * alpha_mask
    out = {"psnr": psnr(img, g), "ssim": ssim(img, g)}
    if with_lpips:
        out["lpips"] = lpips(img, g)
    if pred_invdepth is not None and gt_invdepth is not None:
        valid = (alpha_mask > 0) if alpha_mask is not None \
            else torch.ones_like(pred_invdepth, dtype=torch.bool)
        out["imae"], out["irmse"] = inverse_depth_errors(
            pred_invdepth, gt_invdepth, valid)
    return out


def depth_band_masks(gt_invdepth, alpha_mask=None) -> dict:
    """Masks for near/medium/far bands from a GT inverse-depth map
    (``render_hierarchy_final.py:295-313``): depth = 1/invdepth where
    invdepth > 0."""
    inv, alpha = _tensors(gt_invdepth, alpha_mask)
    valid = inv > 1e-6
    depth = torch.where(valid, 1.0 / torch.clamp(inv, min=1e-6),
                        torch.full_like(inv, math.inf))
    if alpha is not None:
        valid = valid & (alpha > 0)
    return {name: (valid & (depth >= lo) & (depth < hi)).to(torch.float32)
            for name, lo, hi in DEPTH_RANGES}


def category_masks(seg_image, category_colors: dict[str, str]) -> dict:
    """Per-category masks from a color-coded segmentation image [3,H,W] in
    [0,1]; colors given as '#RRGGBB' (``render_hierarchy_final.py:21-28``).
    The color test runs in float64, as the JAX package's numpy does."""
    (seg,) = _tensors(seg_image)
    seg = seg.to(torch.float64)
    out = {}
    for name, hexcolor in category_colors.items():
        rgb = torch.tensor([int(hexcolor[i:i + 2], 16) / 255.0
                            for i in (1, 3, 5)], dtype=torch.float64,
                           device=seg.device)
        match = (torch.abs(seg - rgb[:, None, None])
                 < (10 / 255.0)).all(dim=0)
        out[name] = match[None].to(torch.float32)
    return out


CATEGORY_GROUPS = {
    "sky": "#87CEEB",
    "ground": "#8B4513",
    "buildings": "#696969",
    "vehicles": "#FF4500",
    "vegetation": "#228B22",
    "lamposts": "#FFD700",
}


def aggregate_pixel_weighted(rows: list[dict], weights: list[float]) -> dict:
    """Pixel-weighted metric aggregation across views
    (``render_hierarchy_final.py:390-438``)."""
    if not rows:
        return {}
    total = sum(weights)
    if total <= 0:
        return {k: float("nan") for k in rows[0]}
    out = {}
    for k in rows[0]:
        out[k] = sum(r[k] * w for r, w in zip(rows, weights)
                     if not np.isnan(r[k])) / total
    return out
