"""Tiled front-to-back alpha blending in plain PyTorch (the ``"tiled"``
raster method, the JAX package's default), mirroring
``street_sparse_3dgs_tpu/ops/blend.py``: per chunk of tiles build the
[C, 256, K] alpha matrix, turn transmittance into an exclusive cumprod along
K and contract the weights against the colors."""

from __future__ import annotations

import torch

from .binning import TILE, TileBins
from .oracle import ALPHA_MAX, ALPHA_MIN, T_EPS


def blend_tiles(
    bins: TileBins,
    mean2d: torch.Tensor,     # [N, 2] original rows
    conic: torch.Tensor,      # [N, 3]
    color: torch.Tensor,      # [N, 3]
    opacity: torch.Tensor,    # [N]
    inv_depth: torch.Tensor,  # [N]
    height: int,
    width: int,
    bg: torch.Tensor,         # [3]
    tiles_chunk: int = 16,
):
    """Returns (image [3,H,W], invdepth [1,H,W], alpha [H,W])."""
    # The tables hold depth ranks: move rows into depth order, and append a
    # zero row for the sentinel rank of masked slots.
    def rows(v):
        v = v[bins.order]
        return torch.cat([v, v.new_zeros((1,) + v.shape[1:])])

    mean2d, conic, color, opacity, inv_depth = (
        rows(v) for v in (mean2d, conic, color, opacity, inv_depth))
    tiles_x, tiles_y = bins.tiles_x, bins.tiles_y
    t_total = tiles_x * tiles_y
    dev = mean2d.device
    p = TILE * TILE

    idx = torch.arange(p, device=dev)
    lx = (idx % TILE).to(torch.float32)
    ly = torch.div(idx, TILE, rounding_mode="floor").to(torch.float32)
    gather = bins.gather.to(torch.int64)

    rgb_out, ivd_out, acc_out = [], [], []
    for t0 in range(0, t_total, tiles_chunk):
        tid = torch.arange(t0, min(t_total, t0 + tiles_chunk), device=dev)
        ox = ((tid % tiles_x) * TILE).to(torch.float32)
        oy = (torch.div(tid, tiles_x, rounding_mode="floor") * TILE).to(
            torch.float32)
        px = ox[:, None] + lx[None, :]                     # [C, P]
        py = oy[:, None] + ly[None, :]
        g = gather[tid]                                    # [C, K]
        m = bins.mask[tid]
        mu, co = mean2d[g], conic[g]                       # [C, K, ·]
        rgb, op, ivd = color[g], opacity[g], inv_depth[g]

        dx = px[:, :, None] - mu[:, None, :, 0]            # [C, P, K]
        dy = py[:, :, None] - mu[:, None, :, 1]
        a = co[:, None, :, 0]
        b = co[:, None, :, 1]
        c = co[:, None, :, 2]
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = torch.clamp(op[:, None, :] * torch.exp(power), max=ALPHA_MAX)
        ok = (power <= 0.0) & (alpha >= ALPHA_MIN) & m[:, None, :]
        alpha = torch.where(ok, alpha, torch.zeros_like(alpha))

        log_om = torch.log1p(-alpha)
        cum = torch.cumsum(log_om, dim=-1)
        t_excl = torch.exp(cum - log_om)
        fail = torch.exp(cum) < T_EPS
        include = torch.cumsum(fail.to(torch.int32), dim=-1) == 0

        w = torch.where(include, alpha * t_excl, torch.zeros_like(alpha))
        out_rgb = torch.bmm(w, rgb)                        # [C, P, 3]
        out_ivd = torch.sum(w * ivd[:, None, :], dim=-1)
        acc = torch.sum(w, dim=-1)
        t_final = torch.exp(torch.sum(
            torch.where(include, log_om, torch.zeros_like(log_om)), dim=-1))
        rgb_out.append(out_rgb + t_final[..., None] * bg[None, None, :])
        ivd_out.append(out_ivd)
        acc_out.append(acc)

    def to_image(flat, channels):
        img = flat.reshape(tiles_y, tiles_x, TILE, TILE, channels)
        img = img.permute(0, 2, 1, 3, 4).reshape(tiles_y * TILE,
                                                 tiles_x * TILE, channels)
        return img[:height, :width]

    image = to_image(torch.cat(rgb_out), 3).permute(2, 0, 1)
    invdepth = to_image(torch.cat(ivd_out)[..., None], 1).permute(2, 0, 1)
    alpha_img = to_image(torch.cat(acc_out)[..., None], 1)[..., 0]
    return image, invdepth, alpha_img
