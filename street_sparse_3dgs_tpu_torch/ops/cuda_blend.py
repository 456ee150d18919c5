"""Forward per-tile alpha blending on hand-written CUDA kernels.

The counterpart of ``street_sparse_3dgs_tpu/ops/pallas_blend.py`` for the
forward render: ``pack_gather_attrs`` gathers the [N, 10] attribute rows
into per-tile slots, and ``blend_tiles_pallas`` blends them with

- K1 ``blend_padded`` (``csrc/blend_padded.cu``): attrs channel-major
  [T, 10, K], one tile per block;
- K3 ``blend_exact`` (``csrc/blend_exact.cu``): attrs pair-major
  [T_v, K, 10] over virtual tiles, one block per REAL tile looping over its
  windows.

Both return the packed [T, 8, 256] rows R, G, B, invdepth, alpha, log T,
n_contrib, pad.  Each wrapper launches its kernel on CUDA tensors and runs
its plain PyTorch version (same module) on CPU tensors, and nothing else.
The backward kernels (K2, K4) belong to the training slice: the wrappers'
``backward`` raises.
"""

from __future__ import annotations

import math

import torch

from .. import native
from .binning import TILE, TileBins
from .oracle import ALPHA_MAX, ALPHA_MIN, T_EPS

P = TILE * TILE
N_CH = 10
N_OUT = 8
LOG_EPS = math.log(T_EPS)
OR, OG, OB, OI, OA, OT, ON = range(7)

# Slot-pixel evaluations per chunk of the plain versions ([C, 256, L]).
_PLAIN_ELEMS = 1 << 26


def _kernel_device(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); raises for any other device."""
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise RuntimeError(f"{what}: no kernel for device {x.device}")


def _check(x: torch.Tensor, name: str, dtype, ndim: int,
           device: torch.device) -> None:
    if x.dtype != dtype or x.dim() != ndim or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-d {dtype} "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")


def _tile_pixels(tiles: torch.Tensor, tiles_x: int):
    """[C] tile ids -> pixel coordinates px, py [C, 256]."""
    idx = torch.arange(P, device=tiles.device)
    ox = ((tiles % tiles_x) * TILE).to(torch.float32)
    oy = (torch.div(tiles, tiles_x, rounding_mode="floor") * TILE).to(
        torch.float32)
    px = ox[:, None] + (idx % TILE).to(torch.float32)[None, :]
    py = oy[:, None] + torch.div(idx, TILE, rounding_mode="floor").to(
        torch.float32)[None, :]
    return px, py


def _blend_slots_plain(attrs: torch.Tensor, counts: torch.Tensor,
                       tiles: torch.Tensor, tiles_x: int,
                       bg: torch.Tensor) -> torch.Tensor:
    """Plain blend of C tiles: attrs channel-major [C, 10, L], the first
    ``counts`` [C] slots live, pixel coordinates from ``tiles`` [C], bg
    [C, 3].  Same rules as the kernels (log-space termination that latches
    at the first failing slot).  Returns [C, 8, 256]."""
    ell = attrs.shape[2]
    px, py = _tile_pixels(tiles, tiles_x)
    ch = lambda c: attrs[:, c, None, :]                     # [C, 1, L]
    dx = px[:, :, None] - ch(0)                             # [C, 256, L]
    dy = py[:, :, None] - ch(1)
    power = -0.5 * (ch(2) * dx * dx + ch(4) * dy * dy) - ch(3) * dx * dy
    del dx, dy
    alpha = torch.clamp(ch(8) * torch.exp(torch.clamp(power, max=0.0)),
                        max=ALPHA_MAX)
    live = (torch.arange(ell, device=attrs.device)[None, :]
            < counts[:, None])[:, None, :]                  # [C, 1, L]
    ok = (power <= 0.0) & (alpha >= ALPHA_MIN) & live
    del power
    alpha = torch.where(ok, alpha, torch.zeros_like(alpha))
    lom = torch.log1p(-alpha)
    cum = torch.cumsum(lom, dim=-1)
    fail = cum < LOG_EPS
    include = (torch.cumsum(fail.to(torch.int32), dim=-1) == 0) & live
    w = torch.where(include, alpha * torch.exp(cum - lom),
                    torch.zeros_like(alpha))
    rgb = torch.bmm(w, attrs[:, 5:8, :].transpose(1, 2))    # [C, 256, 3]
    ivd = torch.sum(w * ch(9), dim=-1)
    acc = torch.sum(w, dim=-1)
    tlog = torch.sum(torch.where(include, lom, torch.zeros_like(lom)), dim=-1)
    nc = torch.sum(include, dim=-1).to(torch.float32)
    rgb = rgb + torch.exp(tlog)[:, :, None] * bg[:, None, :]
    return torch.stack([rgb[..., 0], rgb[..., 1], rgb[..., 2], ivd, acc,
                        tlog, nc, torch.zeros_like(acc)], dim=1)


def blend_padded_plain(attrs: torch.Tensor, counts: torch.Tensor,
                       bg: torch.Tensor, tiles_x: int, tile0: int = 0,
                       t_mod: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K1 (same arguments and result as
    ``blend_padded``), in chunks of tiles."""
    t, _, k = attrs.shape
    out = torch.empty((t, N_OUT, P), dtype=torch.float32, device=attrs.device)
    step = max(1, _PLAIN_ELEMS // (P * max(k, 1)))
    counts = torch.clamp(counts, max=k)
    for s in range(0, t, step):
        e = min(t, s + step)
        tiles = torch.arange(s, e, device=attrs.device) + tile0
        if t_mod:
            tiles = tiles % t_mod
        bg_c = bg[s:e] if bg.shape[0] != 1 else bg.expand(e - s, 3)
        out[s:e] = _blend_slots_plain(attrs[s:e], counts[s:e], tiles,
                                      tiles_x, bg_c)
    return out


def blend_exact_plain(attrs: torch.Tensor, vcounts: torch.Tensor,
                      wt: torch.Tensor, last_v: torch.Tensor,
                      bg: torch.Tensor, tiles_x: int,
                      t_mod: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K3: each real tile's windows are
    concatenated into one slot list (only a tile's last window can be
    partial, so its live slots are a prefix) and blended as in K1."""
    nv, k, _ = attrs.shape
    t = last_v.shape[0]
    dev = attrs.device
    last = last_v.to(torch.int64)
    nw = wt.to(torch.int64)[last] + 1
    first = last - nw + 1
    csum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum(vcounts.to(torch.int64), 0)])
    total = csum[last + 1] - csum[first]
    out = torch.empty((t, N_OUT, P), dtype=torch.float32, device=dev)
    nw_host = nw.tolist()
    s = 0
    while s < t:
        # Grow the chunk while its padded slot list stays within budget.
        e = s + 1
        w_max = nw_host[s]
        while e < t:
            w_next = max(w_max, nw_host[e])
            if (e + 1 - s) * w_next * k * P > _PLAIN_ELEMS:
                break
            w_max, e = w_next, e + 1
        j = torch.arange(w_max, device=dev)
        v = first[s:e, None] + j[None, :]
        v = torch.where(j[None, :] < nw[s:e, None], v, torch.zeros_like(v))
        slots = attrs[v].reshape(e - s, w_max * k, N_CH).transpose(1, 2)
        tiles = torch.arange(s, e, device=dev)
        if t_mod:
            tiles = tiles % t_mod
        out[s:e] = _blend_slots_plain(slots, total[s:e], tiles, tiles_x,
                                      bg.expand(e - s, 3))
        s = e
    return out


class _BlendPadded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, attrs, counts, bg, tiles_x, tile0, t_mod):
        t, _, k = attrs.shape
        if not _kernel_device(attrs, "blend_padded"):
            return blend_padded_plain(attrs, counts, bg, tiles_x, tile0,
                                      t_mod)
        out = torch.empty((t, N_OUT, P), dtype=torch.float32,
                          device=attrs.device)
        native.launch("blend_padded", attrs.data_ptr(), counts.data_ptr(),
                      bg.data_ptr(), int(bg.shape[0] != 1), t, k, tiles_x,
                      tile0, t_mod, out.data_ptr())
        return out

    @staticmethod
    def backward(ctx, g_out):
        raise NotImplementedError(
            "the padded blend backward (K2) belongs to the training slice")


class _BlendExact(torch.autograd.Function):
    @staticmethod
    def forward(ctx, attrs, vcounts, wt, last_v, bg, tiles_x, t_mod):
        _, k, _ = attrs.shape
        t = last_v.shape[0]
        if not _kernel_device(attrs, "blend_exact"):
            return blend_exact_plain(attrs, vcounts, wt, last_v, bg, tiles_x,
                                     t_mod)
        out = torch.empty((t, N_OUT, P), dtype=torch.float32,
                          device=attrs.device)
        native.launch("blend_exact", attrs.data_ptr(), vcounts.data_ptr(),
                      wt.data_ptr(), last_v.data_ptr(), bg.data_ptr(), t, k,
                      tiles_x, t_mod, out.data_ptr())
        return out

    @staticmethod
    def backward(ctx, g_out):
        raise NotImplementedError(
            "the exact blend backward (K4) belongs to the training slice")


def blend_padded(attrs: torch.Tensor, counts: torch.Tensor, bg: torch.Tensor,
                 tiles_x: int, tile0: int = 0, t_mod: int = 0) -> torch.Tensor:
    """K1.  attrs [T, 10, K] f32 channel-major, counts [T] int32 (pre-clip
    per-tile pair counts), bg [1, 3] or per-tile [T, 3] f32.  Tile g draws
    pixel coordinates from tile id ``g + tile0`` (wrapped by ``t_mod`` when
    nonzero).  Returns [T, 8, 256]."""
    dev = attrs.device
    _check(attrs, "attrs", torch.float32, 3, dev)
    _check(counts, "counts", torch.int32, 1, dev)
    _check(bg, "bg", torch.float32, 2, dev)
    if attrs.shape[1] != N_CH or counts.shape[0] != attrs.shape[0] or \
            bg.shape[0] not in (1, attrs.shape[0]) or bg.shape[1] != 3:
        raise ValueError("blend_padded: inconsistent shapes "
                         f"{tuple(attrs.shape)} {tuple(counts.shape)} "
                         f"{tuple(bg.shape)}")
    return _BlendPadded.apply(attrs, counts, bg, int(tiles_x), int(tile0),
                              int(t_mod))


def blend_exact(attrs: torch.Tensor, vcounts: torch.Tensor, wt: torch.Tensor,
                last_v: torch.Tensor, bg: torch.Tensor, tiles_x: int,
                t_mod: int = 0) -> torch.Tensor:
    """K3.  attrs [T_v, K, 10] f32 pair-major over virtual tiles; vcounts,
    wt [T_v] and last_v [T] int32 from exact-mode ``TileBins``; bg [1, 3].
    Returns [T, 8, 256] per real tile."""
    dev = attrs.device
    _check(attrs, "attrs", torch.float32, 3, dev)
    for name, x in (("vcounts", vcounts), ("wt", wt), ("last_v", last_v)):
        _check(x, name, torch.int32, 1, dev)
    _check(bg, "bg", torch.float32, 2, dev)
    nv = attrs.shape[0]
    if attrs.shape[2] != N_CH or vcounts.shape[0] != nv or \
            wt.shape[0] != nv or tuple(bg.shape) != (1, 3):
        raise ValueError("blend_exact: inconsistent shapes "
                         f"{tuple(attrs.shape)} {tuple(vcounts.shape)} "
                         f"{tuple(wt.shape)} {tuple(bg.shape)}")
    return _BlendExact.apply(attrs, vcounts, wt, last_v, bg, int(tiles_x),
                             int(t_mod))


def pack_gather_attrs(gather, mean2d, conic, color, opacity, inv_depth,
                      dtype=torch.float32, order=None, rank=None,
                      pair_major=False) -> torch.Tensor:
    """[N, ·] attributes + [T, K] depth-rank table -> packed kernel input:
    channel-major [T, 10, K], or pair-major [T, K, 10] for the exact kernel.

    With ``order`` (``TileBins.order``) the [N, 10] rows are moved into
    depth order first; sentinel ranks (masked slots) read an appended zero
    row.  ``rank`` is accepted for interface parity with the JAX function,
    where it drives the backward of the row permute.  ``dtype=bfloat16``
    rounds the payload to bf16 and back: the TPU kernel upcasts on load, so
    this is its numerics, blended in f32."""
    attrs_n = torch.cat([mean2d, conic, color, opacity[:, None],
                         inv_depth[:, None]], dim=1).to(torch.float32)
    if dtype != torch.float32:
        attrs_n = attrs_n.to(dtype).to(torch.float32)
    if order is not None:
        attrs_n = attrs_n[order]
    attrs_n = torch.cat([attrs_n, attrs_n.new_zeros((1, N_CH))])
    out = attrs_n[gather.to(torch.int64)]                   # [T, K, 10]
    return out if pair_major else out.transpose(1, 2).contiguous()


def _to_image(flat: torch.Tensor, tiles_x: int, tiles_y: int, height: int,
              width: int) -> torch.Tensor:
    ch = flat.shape[1]
    img = flat.reshape(tiles_y, tiles_x, ch, TILE, TILE)
    img = img.permute(2, 0, 3, 1, 4).reshape(ch, tiles_y * TILE,
                                             tiles_x * TILE)
    return img[:, :height, :width]


def blend_tiles_pallas(
    bins: TileBins,
    mean2d: torch.Tensor,     # [N, 2] original rows (permuted internally)
    conic: torch.Tensor,      # [N, 3]
    color: torch.Tensor,      # [N, 3]
    opacity: torch.Tensor,    # [N]
    inv_depth: torch.Tensor,  # [N]
    height: int,
    width: int,
    bg: torch.Tensor,         # [3]
    attr_dtype=torch.float32,
    grad_sort: str = "f32",
    tile_batch: int = 0,
):
    """Forward blend of binned tiles through K1 (padded) or K3 (exact mode,
    when ``bins.t_of_v`` is set).  Returns (image [3,H,W], invdepth
    [1,H,W], alpha [H,W]).  ``grad_sort`` and ``tile_batch`` are TPU
    knobs, accepted for interface parity; they change nothing here."""
    tiles_x, tiles_y = bins.tiles_x, bins.tiles_y
    k_cap = bins.gather.shape[1]
    if k_cap % 128 != 0:
        raise ValueError(f"tile_capacity must be a multiple of 128, "
                         f"got {k_cap}")
    exact = bins.t_of_v is not None
    attrs = pack_gather_attrs(bins.gather, mean2d, conic, color, opacity,
                              inv_depth, dtype=attr_dtype, order=bins.order,
                              rank=bins.rank, pair_major=exact)
    bg2 = bg.reshape(1, 3).to(torch.float32).contiguous()
    if exact:
        out = blend_exact(attrs, bins.vcounts, bins.wt, bins.last_v, bg2,
                          tiles_x)
    else:
        out = blend_padded(attrs, bins.counts.to(torch.int32).contiguous(),
                           bg2, tiles_x)
    image = _to_image(out[:, OR:OB + 1], tiles_x, tiles_y, height, width)
    invdepth = _to_image(out[:, OI:OI + 1], tiles_x, tiles_y, height, width)
    alpha = _to_image(out[:, OA:OA + 1], tiles_x, tiles_y, height, width)[0]
    return image, invdepth, alpha
