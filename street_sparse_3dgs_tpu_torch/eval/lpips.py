"""LPIPS in PyTorch — the port of ``street_sparse_3dgs_tpu/eval/
lpips_jax.py`` (``lpipsPyTorch/modules/{lpips,networks}.py`` analog): a
frozen VGG16 (``F.conv2d`` and 2x2 max-pool), per-level unit-normalized
feature differences and per-channel 1x1 "lin" weights (``lpips.py:32-60``).
It runs on the images' device, in f32 (TF32 off on the card: the eval entry
points turn it off).

Weights resolve in priority order:

1. an ``.npz`` bundle already on disk (``LPIPS_WEIGHTS`` env var, explicit
   path argument, or ``~/.cache/street_sparse_3dgs_tpu/lpips_vgg.npz``) —
   the JAX package's format (``lpips_jax.convert_torch_checkpoints`` makes
   it from the official torch checkpoints).  Nothing is fetched;
2. the documented fallback: He-initialized conv filters drawn with numpy
   from a fixed seed (the same weights as the JAX package's) and uniform
   lin weights.  Random-feature distances are stable for *relative*
   comparison but NOT comparable to published LPIPS numbers —
   ``weights_kind()`` says which mode is active.

Architecture (VGG16 features, slice points after each relu block used by
LPIPS): conv channels 64,64 | 128,128 | 256,256,256 | 512,512,512 |
512,512,512 with 2x2 max-pool between blocks; taps at relu1_2, relu2_2,
relu3_3, relu4_3, relu5_3 (torch feature indices 4, 9, 16, 23, 30).
"""

from __future__ import annotations

import functools
import os
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# Per-block conv output channels; pools between blocks.
_BLOCKS = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
           (512, 512, 512))
_LIN_CH = (64, 128, 256, 512, 512)

# LPIPS ScalingLayer constants (lpipsPyTorch/modules/networks.py).
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

_DEFAULT_CACHE = Path("~/.cache/street_sparse_3dgs_tpu/lpips_vgg.npz")


def _default_weight_path() -> Path | None:
    env = os.environ.get("LPIPS_WEIGHTS")
    if env:
        return Path(env)
    p = _DEFAULT_CACHE.expanduser()
    return p if p.exists() else None


def _random_weights(seed: int = 0) -> dict[str, np.ndarray]:
    """Deterministic He-init VGG + uniform lin weights (fallback mode)."""
    rng = np.random.default_rng(seed)
    w: dict[str, np.ndarray] = {"kind": np.array("random")}
    cin = 3
    i = 0
    for block in _BLOCKS:
        for cout in block:
            std = np.sqrt(2.0 / (cin * 9))
            w[f"conv{i}_w"] = rng.normal(
                0, std, (cout, cin, 3, 3)).astype(np.float32)
            w[f"conv{i}_b"] = np.zeros(cout, np.float32)
            cin = cout
            i += 1
    for lvl, ch in enumerate(_LIN_CH):
        w[f"lin{lvl}"] = np.full(ch, 1.0 / ch, np.float32)
    return w


@functools.lru_cache(maxsize=2)
def load_weights(path: str | None = None) -> dict:
    """Load (and cache) LPIPS weights as numpy arrays; fall back to random
    features."""
    p = Path(path) if path else _default_weight_path()
    if p is not None and Path(p).exists():
        with np.load(p) as z:
            w = {k: z[k] for k in z.files}
        w.setdefault("kind", np.array("calibrated"))
        return w
    return _random_weights()


def weights_kind(path: str | None = None) -> str:
    """'calibrated' (real LPIPS weights loaded) or 'random' (fallback)."""
    return str(load_weights(path)["kind"])


@functools.lru_cache(maxsize=4)
def _device_weights(path: str | None, device: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=device)
            for k, v in load_weights(path).items() if k != "kind"}


def _features(x: torch.Tensor, w: dict) -> list[torch.Tensor]:
    """VGG16 forward taps.  ``x``: [B,3,H,W] in [-1,1]."""
    dev = x.device
    shift = torch.as_tensor(_SHIFT, device=dev)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, device=dev)[None, :, None, None]
    x = (x - shift) / scale
    taps = []
    i = 0
    for bi, block in enumerate(_BLOCKS):
        for _ in block:
            x = F.conv2d(x, w[f"conv{i}_w"], padding=1)
            x = torch.relu(x + w[f"conv{i}_b"][None, :, None, None])
            i += 1
        taps.append(x)
        if bi < len(_BLOCKS) - 1:
            x = F.max_pool2d(x, 2, 2)
    return taps


def _distance(a: torch.Tensor, b: torch.Tensor, w: dict,
              mask: torch.Tensor | None) -> torch.Tensor:
    fa = _features(a, w)
    fb = _features(b, w)
    total = torch.zeros(a.shape[0], dtype=a.dtype, device=a.device)
    for lvl, (xa, xb) in enumerate(zip(fa, fb)):
        na = xa * torch.rsqrt(torch.sum(xa * xa, dim=1, keepdim=True) + 1e-10)
        nb = xb * torch.rsqrt(torch.sum(xb * xb, dim=1, keepdim=True) + 1e-10)
        lin = w[f"lin{lvl}"][None, :, None, None]
        dmap = torch.sum(lin * (na - nb) ** 2, dim=1, keepdim=True)
        if mask is not None:
            # jax.image.resize(..., "bilinear") antialiases when it
            # shrinks: a triangle filter widened by the scale.
            m = F.interpolate(mask, size=dmap.shape[-2:], mode="bilinear",
                              align_corners=False, antialias=True)
            total = total + torch.sum(dmap * m, dim=(1, 2, 3)) / torch.clamp(
                torch.sum(m, dim=(1, 2, 3)), min=1.0)
        else:
            total = total + torch.mean(dmap, dim=(1, 2, 3))
    return total


def _as_batch(x, dev: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, np.float32))
    return x.to(device=dev, dtype=torch.float32)


def _device_of(*xs) -> torch.device:
    return next((x.device for x in xs if isinstance(x, torch.Tensor)),
                torch.device("cpu"))


def lpips(img, gt, mask=None, weights_path: str | None = None) -> float:
    """Perceptual distance of two [3,H,W] images in [0,1] (tensors, run on
    their device, or numpy arrays, on the CPU); with ``mask`` [1,H,W] the
    per-level distance maps are mask-weighted (the fork's masked-LPIPS
    semantics, ``lpipsPyTorch/modules/lpips.py:32-60``)."""
    dev = _device_of(img, gt, mask)
    w = _device_weights(weights_path, dev)
    with torch.no_grad():
        a = _as_batch(img, dev)[None] * 2 - 1
        b = _as_batch(gt, dev)[None] * 2 - 1
        m = None if mask is None else _as_batch(mask, dev)[None]
        return float(_distance(a, b, w, m)[0])


def lpips_batch(imgs, gts, weights_path: str | None = None) -> np.ndarray:
    """Batched [B,3,H,W] LPIPS, one call for a whole eval sweep."""
    dev = _device_of(imgs, gts)
    w = _device_weights(weights_path, dev)
    with torch.no_grad():
        a = _as_batch(imgs, dev) * 2 - 1
        b = _as_batch(gts, dev) * 2 - 1
        return _distance(a, b, w, None).cpu().numpy()
