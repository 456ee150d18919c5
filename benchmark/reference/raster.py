"""Plain PyTorch 3D Gaussian splatting: projection and the per-pixel
depth-ordered blend, forward and backward, written from the 3DGS blend
contract and nothing of the program under test.

The contract: each Gaussian is projected with the EWA approximation
(Jacobian at the clamped mean, 0.3-pixel low-pass on the diagonal), is
culled nearer than 0.2 or off the image, and covers the 16x16 tiles of its
3-sigma rectangle.  A pixel walks the Gaussians of its tile front to back
by depth, skips one whose exponent is positive or whose alpha (opacity x
Gaussian, clamped at 0.99) is under 1/255, and stops at the first one that
would bring its transmittance under 1e-4; what transmittance is left
multiplies the background.  Inverse depth and alpha accumulate with the
same weights.

The blend runs over blocks of tiles padded to their longest list, so that
it fits in memory at 1920x1088 and a million Gaussians.  ``render`` gives
the image without autograd; ``backward`` recomputes each block under
autograd and carries a cotangent of the image back to the projected
attributes.  ``tf32=True`` rounds the operands of every product that a
matrix unit would take (projection, covariance, SH, the blend's weighted
sums) to TF32, the precision below float32 with TF32 off: the control.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

TILE = 16
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
NEAR = 0.2
LOW_PASS = 0.3
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def full_precision() -> None:
    """Float32 products everywhere: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10-bit mantissa (nearest, ties away); the
    gradient passes through."""
    b = x.detach().contiguous().view(torch.int32)
    r = ((b + 0x1000) & -0x2000).view(torch.float32)
    return x + (r - x).detach() if x.requires_grad else r


def mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        a, b = tf32_round(a), tf32_round(b)
    return torch.matmul(a, b)


class Projected(NamedTuple):
    mean2d: torch.Tensor     # [N, 2]
    conic: torch.Tensor      # [N, 3] (a, b, c) of the inverse covariance
    color: torch.Tensor      # [N, 3]
    opacity: torch.Tensor    # [N], 0 where culled
    inv_depth: torch.Tensor  # [N], 0 where culled
    depth: torch.Tensor      # [N]
    radius: torch.Tensor     # [N], 0 where culled
    valid: torch.Tensor      # [N] bool


def sh_basis(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    x, y, z = dirs.unbind(-1)
    out = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        out += [SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2 * zz - xx - yy),
                SH_C2[3] * xz, SH_C2[4] * (xx - yy)]
    if degree >= 3:
        out += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z,
                SH_C3[2] * y * (4 * zz - xx - yy),
                SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
                SH_C3[6] * x * (xx - 3 * yy)]
    return torch.stack(out, -1)


def quat_rotation(q: torch.Tensor) -> torch.Tensor:
    q = q / q.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def project(means, scales, quats, opacities, shs, cam: dict,
            sh_degree: int, tf32: bool = False) -> Projected:
    """Screen-space attributes of activated rows for camera ``cam`` (the
    dict of ``benchmark.scene.camera``)."""
    dev = means.device
    view = torch.as_tensor(cam["view"], device=dev)
    proj = torch.as_tensor(cam["proj"], device=dev)
    n = means.shape[0]
    hom = torch.cat([means, means.new_ones(n, 1)], 1)
    p_view = mm(hom, view.T, tf32)
    p_clip = mm(hom, proj.T, tf32)
    depth = p_view[:, 2]
    w = p_clip[:, 3]
    w = torch.where(w.abs() > 1e-7, w, torch.full_like(w, 1e-7))
    size = torch.tensor([cam["width"], cam["height"]], dtype=torch.float32,
                        device=dev)
    mean2d = ((p_clip[:, :2] / w[:, None] + 1.0) * size - 1.0) * 0.5

    M = mm(view[:3, :3], quat_rotation(quats) * scales[:, None, :], tf32)
    cov = mm(M, M.transpose(1, 2), tf32)
    tz = depth.clamp(min=1e-6)
    lx, ly = 1.3 * cam["tan_fovx"], 1.3 * cam["tan_fovy"]
    tx = (p_view[:, 0] / tz).clamp(-lx, lx) * tz
    ty = (p_view[:, 1] / tz).clamp(-ly, ly) * tz
    fx, fy = cam["focal_x"], cam["focal_y"]
    zero = torch.zeros_like(tz)
    J = torch.stack([torch.stack([fx / tz, zero, -fx * tx / (tz * tz)], -1),
                     torch.stack([zero, fy / tz, -fy * ty / (tz * tz)], -1)],
                    -2)
    cov2 = mm(mm(J, cov, tf32), J.transpose(1, 2), tf32)
    cxx = cov2[:, 0, 0] + LOW_PASS
    cxy = cov2[:, 0, 1]
    cyy = cov2[:, 1, 1] + LOW_PASS
    det = cxx * cyy - cxy * cxy
    inv = 1.0 / torch.where(det > 0, det, torch.ones_like(det))
    conic = torch.stack([cyy * inv, -cxy * inv, cxx * inv], -1)
    mid = 0.5 * (cxx + cyy)
    lam = mid + torch.sqrt((mid * mid - det).clamp(min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam.clamp(min=0.0)))
    valid = ((depth > NEAR) & (det > 0)
             & (mean2d[:, 0] + radius >= 0)
             & (mean2d[:, 0] - radius <= cam["width"])
             & (mean2d[:, 1] + radius >= 0)
             & (mean2d[:, 1] - radius <= cam["height"]) & (radius > 0))

    d = means - torch.as_tensor(cam["campos"], device=dev)
    d = d / d.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    k = (sh_degree + 1) ** 2
    basis = sh_basis(d, sh_degree)[:, None, :]
    color = (mm(basis, shs[:, :k, :], tf32)[:, 0] + 0.5).clamp(min=0.0)
    z = torch.zeros_like(depth)
    return Projected(mean2d=mean2d, conic=conic, color=color,
                     opacity=torch.where(valid, opacities, z),
                     inv_depth=torch.where(valid, 1.0 / tz, z),
                     depth=depth, radius=torch.where(valid, radius, z),
                     valid=valid)


class Plan(NamedTuple):
    """Each tile's Gaussians in depth order, in blocks of tiles."""
    rows: torch.Tensor       # [P] projected row of each (tile, Gaussian) pair
    start: torch.Tensor      # [T] first pair of each tile
    count: torch.Tensor      # [T] pairs of each tile
    blocks: list             # [(tile ids [B], L)]
    tiles_x: int
    height: int
    width: int


def _tile_index(v: torch.Tensor, hi: int) -> torch.Tensor:
    return torch.floor(v / TILE).clamp(0, hi).to(torch.int64)


def plan_tiles(p: Projected, height: int, width: int,
               block_elems: int = 1 << 25) -> Plan:
    """Pairs of every valid Gaussian with the tiles of its rectangle,
    less the tiles where even its best pixel stays under 1/255 (the
    smallest eigenvalue of the conic bounds the exponent from below)."""
    with torch.no_grad():
        dev = p.mean2d.device
        tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
        vid = torch.nonzero(p.valid).reshape(-1)
        m = p.mean2d[vid]
        r = p.radius[vid]
        x0 = _tile_index(m[:, 0] - r, tiles_x)
        y0 = _tile_index(m[:, 1] - r, tiles_y)
        x1 = torch.maximum(_tile_index(m[:, 0] + r + TILE - 1, tiles_x), x0)
        y1 = torch.maximum(_tile_index(m[:, 1] + r + TILE - 1, tiles_y), y0)
        nx = x1 - x0
        cover = nx * (y1 - y0)
        pair_g = torch.repeat_interleave(torch.arange(vid.numel(), device=dev),
                                         cover)
        first = torch.cumsum(cover, 0) - cover
        k = torch.arange(pair_g.numel(), device=dev) - first[pair_g]
        nxg = nx[pair_g].clamp(min=1)
        tx = x0[pair_g] + k % nxg
        ty = y0[pair_g] + torch.div(k, nxg, rounding_mode="floor")
        # Distance from the mean to the tile's pixel box, and the bound.
        mx, my = m[pair_g, 0], m[pair_g, 1]
        ddx = torch.clamp(torch.maximum(tx * TILE - mx, mx - (tx * TILE + 15)),
                          min=0)
        ddy = torch.clamp(torch.maximum(ty * TILE - my, my - (ty * TILE + 15)),
                          min=0)
        a, b, c = p.conic[vid].unbind(-1)
        lam_min = (0.5 * (a + c) - torch.sqrt(0.25 * (a - c) ** 2 + b * b))
        q = lam_min[pair_g].clamp(min=0) * (ddx * ddx + ddy * ddy)
        reach = p.opacity[vid][pair_g] * torch.exp(-0.5 * q) >= ALPHA_MIN * 0.99
        pair_g, tile = pair_g[reach], (ty * tiles_x + tx)[reach]
        depth_rank = torch.empty_like(vid)
        depth_rank[torch.sort(p.depth[vid], stable=True).indices] = \
            torch.arange(vid.numel(), device=dev)
        key = tile * vid.numel() + depth_rank[pair_g]
        rows = vid[pair_g[torch.sort(key).indices]]
        n_t = tiles_x * tiles_y
        count = torch.bincount(tile, minlength=n_t)
        start = torch.cumsum(count, 0) - count
        order = torch.sort(count, descending=True, stable=True)
        blocks = []
        cnt = order.values.tolist()
        ids = order.indices
        i = 0
        while i < n_t and cnt[i] > 0:
            length = cnt[i]
            b = max(1, min(n_t - i, block_elems // (TILE * TILE * length)))
            blocks.append((ids[i:i + b], length))
            i += b
        return Plan(rows, start, count, blocks, tiles_x, height, width)


def _pixels(tiles: torch.Tensor, tiles_x: int):
    loc = torch.arange(TILE * TILE, device=tiles.device)
    px = (tiles % tiles_x)[:, None] * TILE + loc % TILE
    py = torch.div(tiles, tiles_x, rounding_mode="floor")[:, None] * TILE \
        + torch.div(loc, TILE, rounding_mode="floor")
    return px, py


def _blend_block(plan: Plan, tiles, length, attrs, bg, tf32: bool):
    """(color [B, 256, 3], inv depth [B, 256], alpha [B, 256], passing
    Gaussians [B, 256], pixel x, pixel y) of one block.  ``attrs`` are
    (mean2d, conic, color, opacity, inv_depth) with a zero row appended."""
    mean2d, conic, color, opac, invd = attrs
    sentinel = mean2d.shape[0] - 1
    j = torch.arange(length, device=tiles.device)
    live = j[None, :] < plan.count[tiles][:, None]
    idx = plan.rows[(plan.start[tiles][:, None] + j).clamp(
        max=max(plan.rows.numel() - 1, 0))]
    idx = torch.where(live, idx, torch.full_like(idx, sentinel))
    px, py = _pixels(tiles, plan.tiles_x)
    m = mean2d[idx]
    dx = px.float()[:, :, None] - m[:, None, :, 0]
    dy = py.float()[:, :, None] - m[:, None, :, 1]
    cn = conic[idx]
    power = (-0.5 * (cn[:, None, :, 0] * dx * dx + cn[:, None, :, 2] * dy * dy)
             - cn[:, None, :, 1] * dx * dy)
    alpha = torch.clamp(opac[idx][:, None, :] * torch.exp(power),
                        max=ALPHA_MAX)
    ok = (power <= 0) & (alpha >= ALPHA_MIN)
    alpha = torch.where(ok, alpha, torch.zeros_like(alpha))
    lg = torch.log1p(-alpha)
    cum = torch.cumsum(lg, -1)
    include = torch.cumsum((torch.exp(cum) < T_EPS).to(torch.int32), -1) == 0
    w = torch.where(include, alpha * torch.exp(cum - lg),
                    torch.zeros_like(alpha))
    col = mm(w, color[idx], tf32)
    inv = mm(w, invd[idx][:, :, None], tf32)[..., 0]
    acc = w.sum(-1)
    t_end = torch.exp(torch.where(include, lg, torch.zeros_like(lg)).sum(-1))
    col = col + t_end[..., None] * bg
    passes = (include & ok).sum(-1)
    return col, inv, acc, passes, px, py


def _with_sentinel(attrs):
    return tuple(torch.cat([a, a.new_zeros((1,) + a.shape[1:])])
                 for a in attrs)


def attrs_of(p: Projected):
    return (p.mean2d, p.conic, p.color, p.opacity, p.inv_depth)


def render(plan: Plan, attrs, bg: torch.Tensor, tf32: bool = False):
    """(image [3, H, W], inv depth [1, H, W], alpha [H, W], passing
    Gaussians summed over the pixels) without autograd."""
    h, w = plan.height, plan.width
    dev = bg.device
    img = bg[:, None].expand(3, h * w).clone()
    invd = torch.zeros(h * w, device=dev)
    acc = torch.zeros(h * w, device=dev)
    passes = torch.zeros((), dtype=torch.int64, device=dev)
    with torch.no_grad():
        ext = _with_sentinel(tuple(a.detach() for a in attrs))
        for tiles, length in plan.blocks:
            col, inv, al, ps, px, py = _blend_block(plan, tiles, length, ext,
                                                    bg, tf32)
            inside = (px < w) & (py < h)
            lin = (py * w + px)[inside]
            img[:, lin] = col[inside].T
            invd[lin] = inv[inside]
            acc[lin] = al[inside]
            passes += ps[inside].sum()
    return img.reshape(3, h, w), invd.reshape(1, h, w), acc.reshape(h, w), \
        int(passes)


def backward(plan: Plan, attrs, bg: torch.Tensor, d_img: torch.Tensor,
             d_invd: torch.Tensor, tf32: bool = False):
    """Cotangents of ``attrs`` for image and inverse-depth cotangents
    ``d_img`` [3, H, W] and ``d_invd`` [1, H, W], block by block."""
    h, w = plan.height, plan.width
    leaves = tuple(a.detach().requires_grad_(True) for a in attrs)
    g_img = d_img.reshape(3, h * w)
    g_inv = d_invd.reshape(h * w)
    for tiles, length in plan.blocks:
        col, inv, _, _, px, py = _blend_block(
            plan, tiles, length, _with_sentinel(leaves), bg, tf32)
        inside = (px < w) & (py < h)
        lin = torch.where(inside, py * w + px, torch.zeros_like(px))
        gc = torch.where(inside[..., None], g_img[:, lin].permute(1, 2, 0),
                         torch.zeros_like(col))
        gi = torch.where(inside, g_inv[lin], torch.zeros_like(inv))
        torch.autograd.backward([col, inv], [gc, gi])
    return tuple(x.grad if x.grad is not None else torch.zeros_like(x)
                 for x in leaves)


def frame_uint8(img: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] uint8 as a viewer serves it: clamp, x255, truncate."""
    return (img.clamp(0.0, 1.0).permute(1, 2, 0) * 255).to(torch.uint8)


def pixel_limit(tau: float, tan_fovx: float, width: int) -> float:
    return (2.0 * (tau + 0.5)) * tan_fovx / (0.5 * width)


def _norm3(x):
    return torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2 + x[..., 2] ** 2)


def cut_rows(h: dict, campos, limit: float):
    """The view-dependent cut of an H3DGS tree and its rows: a node renders
    when its size over distance is under the limit (or it is a leaf) and
    its parent's is not; it is interpolated toward its parent by
    t = (m_parent - limit) / (m_parent - m_node), clamped to [1e-6, 1].
    Returns activated (means, scales, quats, opacities, shs)."""
    dev = h["xyz"].device
    c = torch.as_tensor(campos, device=dev)
    dist = (_norm3(h["box_center"] - c) - _norm3(h["box_half"])).clamp(min=1e-6)
    metric = h["size"] / dist
    root = h["parent"] < 0
    par = h["parent"].clamp(min=0).long()
    pm = torch.where(root, torch.full_like(metric, math.inf), metric[par])
    sel = ((metric <= limit) | (h["child_count"] == 0)) & (pm > limit)
    t = (pm - limit) / (pm - metric).clamp(min=1e-6)
    t = torch.where(torch.isinf(pm), torch.ones_like(t), t).clamp(0.0, 1.0)
    t = t.clamp(min=1e-6)
    ids = torch.nonzero(sel).reshape(-1)
    pids = torch.where(root[ids], ids, par[ids])
    wgt = t[ids][:, None]

    def lerp(x):
        shape = (-1,) + (1,) * (x.dim() - 1)
        ww = wgt.reshape(shape)
        return ww * x[ids] + (1 - ww) * x[pids]

    sh = torch.cat([h["features_dc"], h["features_rest"]], 1)
    q_n, q_p = h["quats"][ids], h["quats"][pids]
    q_p = torch.where((q_p * q_n).sum(-1, keepdim=True) < 0, -q_p, q_p)
    return (lerp(h["xyz"]), lerp(torch.exp(h["log_scales"])),
            wgt * q_n + (1 - wgt) * q_p, lerp(h["opacity_raw"][:, 0].abs()),
            lerp(sh))
