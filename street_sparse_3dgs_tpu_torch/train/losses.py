"""Training losses, mirroring ``street_sparse_3dgs_tpu/train/losses.py``:
L1, L2, SSIM (plain and masked, 11x11 sigma 1.5 window, C1 = 0.01^2,
C2 = 0.03^2), the photometric mix, the inverse-depth terms and PSNR.

The SSIM window is two separable depthwise ``F.conv2d`` passes with zero
padding.  The JAX package runs them at HIGHEST precision; here they must
not run in TF32 either: the training, post-opt and eval entry points turn
it off for cuDNN and matmuls (``tf32_off``), and ``chip_smoke.py``
asserts it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

_C1 = 0.01 ** 2
_C2 = 0.03 ** 2


def tf32_off() -> None:
    """Full f32 for cuDNN convolutions (the SSIM window, LPIPS) and matmuls,
    as the JAX package runs them; the training, post-opt and eval entry
    points call it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


@functools.lru_cache(maxsize=None)
def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    x = np.arange(window_size, dtype=np.float32) - window_size // 2
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / np.sum(g)


def _blur(img: torch.Tensor, window_size: int = 11,
          sigma: float = 1.5) -> torch.Tensor:
    """Depthwise Gaussian blur of a [C, H, W] image, zero padding."""
    w = torch.as_tensor(_gaussian_window(window_size, sigma),
                        device=img.device)
    pad = window_size // 2
    x = img[:, None]                                     # [C, 1, H, W]
    x = F.conv2d(x, w.reshape(1, 1, window_size, 1), padding=(pad, 0))
    x = F.conv2d(x, w.reshape(1, 1, 1, window_size), padding=(0, pad))
    return x[:, 0]


def ssim_map(img1: torch.Tensor, img2: torch.Tensor,
             window_size: int = 11) -> torch.Tensor:
    """Per-pixel SSIM of two [C, H, W] images (reference ``_ssim``)."""
    mu1 = _blur(img1, window_size)
    mu2 = _blur(img2, window_size)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _blur(img1 * img1, window_size) - mu1_sq
    sigma2_sq = _blur(img2 * img2, window_size) - mu2_sq
    sigma12 = _blur(img1 * img2, window_size) - mu12
    return (((2.0 * mu12 + _C1) * (2.0 * sigma12 + _C2))
            / ((mu1_sq + mu2_sq + _C1) * (sigma1_sq + sigma2_sq + _C2)))


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    return torch.mean(ssim_map(img1, img2, window_size))


def masked_ssim(img1: torch.Tensor, img2: torch.Tensor, mask: torch.Tensor,
                window_size: int = 11) -> torch.Tensor:
    """SSIM over valid pixels only, each window's statistics renormalised
    by its valid-pixel fraction (reference ``utils/loss_utils.py:65-155``)."""
    m = torch.broadcast_to(mask, img1.shape).to(img1.dtype)
    frac_safe = torch.clamp(_blur(m, window_size), min=1e-8)

    def wmean(x):
        return _blur(x * m, window_size) / frac_safe

    mu1, mu2 = wmean(img1), wmean(img2)
    sigma1_sq = wmean(img1 * img1) - mu1 * mu1
    sigma2_sq = wmean(img2 * img2) - mu2 * mu2
    sigma12 = wmean(img1 * img2) - mu1 * mu2
    smap = (((2.0 * mu1 * mu2 + _C1) * (2.0 * sigma12 + _C2))
            / ((mu1 * mu1 + mu2 * mu2 + _C1)
               * (sigma1_sq + sigma2_sq + _C2)))
    valid = m > 0.0
    return torch.sum(torch.where(valid, smap, torch.zeros_like(smap))) / \
        torch.clamp(torch.sum(valid.to(img1.dtype)), min=1.0)


def photometric(image: torch.Tensor, gt: torch.Tensor,
                lambda_dssim: float = 0.2) -> torch.Tensor:
    """(1-lambda) L1 + lambda (1 - SSIM) (``train_single.py:121-123``)."""
    return ((1.0 - lambda_dssim) * l1(image, gt)
            + lambda_dssim * (1.0 - ssim(image, gt)))


def depth_l1(inv_depth: torch.Tensor, mono_invdepth: torch.Tensor,
             depth_mask: torch.Tensor) -> torch.Tensor:
    """Masked inverse-depth L1, mean over all pixels."""
    return torch.mean(torch.abs((inv_depth - mono_invdepth) * depth_mask))


def depth_hinge(inv_depth: torch.Tensor,
                mono_invdepth: torch.Tensor) -> torch.Tensor:
    """Penalise rendering farther than the LiDAR depth:
    mean(max(mono - pred, 0))."""
    return torch.mean(torch.clamp(mono_invdepth - inv_depth, min=0.0))


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((img1 - img2) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


def psnr_masked(img1: torch.Tensor, img2: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Masked MSE -> PSNR (reference ``utils/image_utils.py``)."""
    m = torch.broadcast_to(mask, img1.shape)
    denom = torch.clamp(torch.sum(m), min=1.0)
    mse = torch.sum(torch.where(m > 0, (img1 - img2) ** 2,
                                torch.zeros_like(img1))) / denom
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))
