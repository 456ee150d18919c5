"""Dense reference rasterizer, mirroring ``street_sparse_3dgs_tpu/ops/
oracle.py``: O(pixels × N), for small scenes only.

Semantics (the 3DGS blend contract): front-to-back in depth order; a
Gaussian is skipped at a pixel when its exponent is positive or its alpha
is below 1/255; alpha is clamped at 0.99; a pixel stops at the first
Gaussian that would push transmittance below 1e-4; remaining transmittance
multiplies the background; inverse depth accumulates with the same weights.
"""

from __future__ import annotations

import torch

from .preprocess import Projected

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


def blend_pixels(pix_xy: torch.Tensor, proj: Projected, bg: torch.Tensor,
                 tile_grid: tuple[int, int] | None = None):
    """Returns (color [P,3], inv_depth [P], alpha [P]).  With ``tile_grid``
    each Gaussian only touches pixels whose 16×16 tile lies in its covered
    rectangle, like the tiled paths."""
    order = torch.sort(proj.depth, stable=True).indices
    mean2d = proj.mean2d[order]
    conic = proj.conic[order]
    color = proj.color[order]
    opac = proj.opacity[order]
    invd = proj.inv_depth[order]
    valid = proj.valid[order]

    if tile_grid is not None:
        from .binning import TILE, tile_rect
        tiles_x, tiles_y = tile_grid
        x0, y0, x1, y1 = tile_rect(mean2d, proj.radius[order], tiles_x,
                                   tiles_y)
        ptx = torch.div(pix_xy[:, 0], TILE, rounding_mode="floor").to(
            torch.int32)
        pty = torch.div(pix_xy[:, 1], TILE, rounding_mode="floor").to(
            torch.int32)
        in_rect = ((ptx[:, None] >= x0[None, :]) & (ptx[:, None] < x1[None, :])
                   & (pty[:, None] >= y0[None, :])
                   & (pty[:, None] < y1[None, :]))
    else:
        in_rect = torch.ones((), dtype=torch.bool, device=pix_xy.device)

    dx = pix_xy[:, None, 0] - mean2d[None, :, 0]            # [P, N]
    dy = pix_xy[:, None, 1] - mean2d[None, :, 1]
    a, b, c = conic[:, 0], conic[:, 1], conic[:, 2]
    power = -0.5 * (a[None] * dx * dx + c[None] * dy * dy) - b[None] * dx * dy
    alpha = torch.clamp(opac[None, :] * torch.exp(power), max=ALPHA_MAX)
    ok = (power <= 0.0) & (alpha >= ALPHA_MIN) & valid[None, :] & in_rect
    alpha = torch.where(ok, alpha, torch.zeros_like(alpha))

    log_one_minus = torch.log1p(-alpha)
    cum = torch.cumsum(log_one_minus, dim=1)
    t_excl = torch.exp(cum - log_one_minus)
    fail = torch.exp(cum) < T_EPS
    include = torch.cumsum(fail.to(torch.int32), dim=1) == 0

    w = torch.where(include, alpha * t_excl, torch.zeros_like(alpha))
    out_color = w @ color
    out_invd = w @ invd
    acc_alpha = torch.sum(w, dim=1)
    t_final = torch.exp(torch.sum(
        torch.where(include, log_one_minus, torch.zeros_like(alpha)), dim=1))
    out_color = out_color + t_final[:, None] * bg[None, :]
    return out_color, out_invd, acc_alpha


def render_oracle(proj: Projected, height: int, width: int, bg: torch.Tensor,
                  tile_grid: tuple[int, int] | None = None):
    """Dense full-image render: (image [3,H,W], invdepth [1,H,W],
    alpha [H,W])."""
    dev = proj.mean2d.device
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    py, px = torch.meshgrid(ys, xs, indexing="ij")          # [H, W]
    pix = torch.stack([px.reshape(-1), py.reshape(-1)], dim=-1)
    color, invd, acc = blend_pixels(pix, proj, bg, tile_grid=tile_grid)
    image = color.reshape(height, width, 3).permute(2, 0, 1)
    invdepth = invd.reshape(1, height, width)
    return image, invdepth, acc.reshape(height, width)
