"""Per-tile alpha blending on hand-written CUDA kernels, forward and
backward.

The counterpart of ``street_sparse_3dgs_tpu/ops/pallas_blend.py``:
``pack_gather_attrs`` gathers the [N, 10] attribute rows into per-tile
slots, and ``blend_tiles_pallas`` blends them with

- K1 ``blend_padded`` (``csrc/blend_padded.cu``): attrs channel-major
  [T, 10, K], one tile per block; its backward is K2
  (``csrc/blend_padded_bwd.cu``);
- K3 ``blend_exact`` (``csrc/blend_exact.cu``): attrs pair-major
  [T_v, K, 10] over virtual tiles, one block per REAL tile looping over its
  windows, except that a tile of more than EXACT_GROUP windows is split in
  groups of windows walked by blocks of their own (``exact_split_plan``;
  plain twin ``blend_exact_split_plain``); its backward is K4
  (``csrc/blend_exact_bwd.cu``), which takes the real tiles deepest first
  (``exact_tile_order``).

K1 and K3 share one forward walk (``csrc/blend_fwd.cuh``), whose per-slot
skip threshold ``alpha_skip_threshold`` mirrors; K2 and K4 share one
backward walk (``csrc/blend_bwd.cuh``).  K3's kernels
(``csrc/blend_exact.cuh``) also run the kernel-floor stubs
(``tools/kernel_floor.py``), on buffers from ``exact_scratch``.

The forwards return the packed [T, 8, 256] rows R, G, B, invdepth, alpha,
log T, n_contrib, pad; the backwards take those saved rows and the
cotangent of the same shape and return per-slot grads in the attrs' layout.
Each wrapper launches its kernel on CUDA tensors and runs its plain
PyTorch version (same module) on CPU tensors, and nothing else; on CPU
tensors the autograd ``backward`` runs the plain backward versions.

Around the kernels, as in the JAX module: the background gradient is a
reduction outside the kernel, and ``pack_gather_attrs`` carries the
slot grads back to Gaussian rows (``slot_grads_to_rows``: a stable sort of
the slot ids and a segment sum, segments from ``TileBins.seg_pos`` under
``grad_reduce="counts"``) and then through the inverse row permute
(``binning.permute_rows``).

Determinism on the card: K2 and K4 reduce each slot over its pixels in a
fixed order with no atomics; the background grad is a ``torch.sum``; the
slot->row reduction is a stable sort, a gather and ``segment_reduce``
(one serial sum per segment); the permute backward is a gather.  So the
blend backward gives bit-identical grads when run twice on the same
inputs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import native
from ..profiling import span
from .binning import TILE, TileBins, permute_rows
from .oracle import ALPHA_MAX, ALPHA_MIN, T_EPS

P = TILE * TILE
N_CH = 10
N_OUT = 8
LOG_EPS = math.log(T_EPS)
SKIP_DELTA = 1e-4        # margin of the forward kernels' skip threshold
# Windows a group of K3's split walks (csrc/blend_exact.cu): tiles with
# more windows are cut into groups of this many.  In a 1920x1088 street
# view 94% of the tiles have at most 4 windows and stay whole, while the
# deepest (30 to 70 windows) become 8 to 18 groups in parallel; a group's
# walk is the path of its tile.  On the H100 the launch is as fast at 4 as
# at 8 at street view 0 and faster at 960x544, whose deepest tile has 30
# windows; 2 costs more (PERF.md).
EXACT_GROUP = 4
OR, OG, OB, OI, OA, OT, ON = range(7)

# Slot-pixel evaluations per chunk of the plain versions ([C, 256, L]).
_PLAIN_ELEMS = 1 << 26
# The plain backward keeps about twice as many [C, 256, L] temporaries.
_PLAIN_BWD_ELEMS = 1 << 24


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
    nc = torch.sum(include, dim=-1).to(attrs.dtype)
    rgb = rgb + torch.exp(tlog)[:, :, None] * bg[:, None, :]
    return torch.stack([rgb[..., 0], rgb[..., 1], rgb[..., 2], ivd, acc,
                        tlog, nc, torch.zeros_like(acc)], dim=1)


def blend_padded_plain(attrs: torch.Tensor, counts: torch.Tensor,
                       bg: torch.Tensor, tiles_x: int, tile0: int = 0,
                       t_mod: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K1 (same arguments and result as
    ``blend_padded``), in chunks of tiles."""
    t, _, k = attrs.shape
    out = torch.empty((t, N_OUT, P), dtype=attrs.dtype, device=attrs.device)
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


def _exact_chunks(vcounts: torch.Tensor, wt: torch.Tensor,
                  last_v: torch.Tensor, k: int, elems: int):
    """Chunks of real tiles for the plain exact versions.  Each real tile's
    windows are concatenated into one slot list; only a tile's last window
    can be partial, so its live slots are a prefix.  Yields (s, e, v,
    valid, total): tiles [s, e), the [C, W] window ids of their slot lists
    (``valid`` marks the real ones; the rest read window 0) and each tile's
    live slot count [C]."""
    last = last_v.to(torch.int64)
    nw = wt.to(torch.int64)[last] + 1
    yield from _run_chunks(vcounts, last - nw + 1, nw, k, elems)


def _run_chunks(vcounts: torch.Tensor, first: torch.Tensor, nw: torch.Tensor,
                k: int, elems: int):
    """``_exact_chunks`` over runs of windows: run i is windows
    [first[i], first[i] + nw[i]) (int64), whose live slots are a prefix."""
    t = first.shape[0]
    dev = vcounts.device
    csum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum(vcounts.to(torch.int64), 0)])
    total = csum[first + nw] - csum[first]
    nw_host = nw.tolist()
    s = 0
    while s < t:
        # Grow the chunk while its padded slot list stays within budget.
        e = s + 1
        w_max = nw_host[s]
        while e < t:
            w_next = max(w_max, nw_host[e])
            if (e + 1 - s) * w_next * k * P > elems:
                break
            w_max, e = w_next, e + 1
        j = torch.arange(w_max, device=dev)
        valid = j[None, :] < nw[s:e, None]
        v = torch.where(valid, first[s:e, None] + j[None, :],
                        torch.zeros_like(valid, dtype=torch.int64))
        yield s, e, v, valid, total[s:e]
        s = e


def _order_tiles(last_v: torch.Tensor,
                 order: torch.Tensor | None) -> torch.Tensor:
    """The real tiles [n] int64 a plain exact version walks: those of
    ``order``, else all in tile order."""
    if order is None:
        return torch.arange(last_v.shape[0], device=last_v.device)
    return order.to(torch.int64)


def blend_exact_plain(attrs: torch.Tensor, vcounts: torch.Tensor,
                      wt: torch.Tensor, last_v: torch.Tensor,
                      bg: torch.Tensor, tiles_x: int, t_mod: int = 0,
                      order: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of K3: each real tile's windows are
    concatenated into one slot list and blended as in K1.  With ``order``
    only its tiles are blended and the rows of the others are zero."""
    _, k, _ = attrs.shape
    tiles = _order_tiles(last_v, order)
    alloc = torch.empty if order is None else torch.zeros
    out = alloc((last_v.shape[0], N_OUT, P), dtype=attrs.dtype,
                device=attrs.device)
    for s, e, v, _, total in _exact_chunks(vcounts, wt, last_v[tiles], k,
                                           _PLAIN_ELEMS):
        slots = attrs[v].reshape(e - s, -1, N_CH).transpose(1, 2)
        out[tiles[s:e]] = _blend_slots_plain(
            slots, total, _tile_mod(tiles[s:e], t_mod), tiles_x,
            bg.expand(e - s, 3))
    return out


def alpha_skip_threshold(op: torch.Tensor) -> torch.Tensor:
    """The forward kernels' per-slot skip threshold, in float32 as they
    compute it (``csrc/blend_fwd.cuh`` skip_threshold): log(ALPHA_MIN / op)
    - SKIP_DELTA, or +inf where op < ALPHA_MIN.  A slot whose power at a
    pixel lies below it cannot pass the alpha test there."""
    op = op.to(torch.float32)
    a_min = torch.tensor(ALPHA_MIN, dtype=torch.float32, device=op.device)
    thr = torch.log(a_min / op) - torch.tensor(SKIP_DELTA,
                                               dtype=torch.float32)
    return torch.where(op < a_min, torch.full_like(op, math.inf), thr)


def _split_sizes(n: int, nv: int, t: int, group: int):
    """(block table rows, pass-2 and combine rows, scratch slots) of K3
    for ``n`` of the ``t`` real tiles over ``nv`` windows: bounds from the
    shapes alone.  Each real tile owns w >= 1 windows of its own, so the
    windows beyond one a tile sum to at most E = nv - t.  A split tile has
    w - 1 >= group of them; its ceil(w / group) - 1 <= (w - 1) / group
    groups after group 0, and its ceil(w / group) <= 2 (w - 1) / group
    scratch slots."""
    e = max(nv - t, 0)
    if group <= 0:
        return n, 0, 0
    return n + e // group, e // group, 2 * e // group


def exact_split_plan(vcounts: torch.Tensor, wt: torch.Tensor,
                     last_v: torch.Tensor, group: int,
                     order: torch.Tensor | None = None):
    """K3's block tables, built on the tensors' device without a host
    read.  The real tiles of ``order`` (all in tile order when not given),
    in that order; a tile of at most ``group`` windows (or any tile when
    ``group`` is 0) is one block, a deeper one is cut into groups of
    ``group`` consecutive windows, one block each, in window order.

    Returns (table, pass2, combine, slots), with E = T_v - T:
    - table [n + E // group, 4] int32, one row per block of pass 1: real
      tile, first window, windows, scratch slot q of a group (-1 for a tile
      walked whole).  The groups of a tile have consecutive slots.  Rows
      past the blocks in use have tile -1.
    - pass2 [E // group, 4] int32: the rows of ``table`` for the groups
      after each split tile's group 0, in table order; then tile -1.
    - combine [E // group, 3] int32, one row per split tile in order:
      tile, its first slot, its groups; rows past them tile -1.
    - slots: the number of scratch slots to allocate (a bound on q + 1).
    The sizes are bounds from the shapes (``_split_sizes``).  The plain
    version of K3's plan kernel (``csrc/blend_exact.cu``
    exact_plan_kernel), which writes the same rows."""
    dev = last_v.device
    if order is None:
        order = torch.arange(last_v.shape[0], device=dev)
    o = order.to(torch.int64)
    n, nv = o.shape[0], vcounts.shape[0]
    last = last_v.to(torch.int64)[o]
    nw = wt.to(torch.int64)[last] + 1
    first = last - nw + 1
    n_table, n_extra, slots = _split_sizes(n, nv, last_v.shape[0], group)
    none = torch.tensor([[-1, 0, 0, -1]], dtype=torch.int32, device=dev)
    if group <= 0 or n == 0:
        table = torch.stack([o, first, nw, torch.full_like(o, -1)], dim=1)
        table = torch.cat([table.to(torch.int32),
                           none.expand(n_table - n, 4)])
        return (table.contiguous(), none.expand(n_extra, 4).contiguous(),
                torch.full((n_extra, 3), -1, dtype=torch.int32, device=dev),
                slots)
    split = nw > group
    ng = torch.where(split, (nw + group - 1) // group, torch.ones_like(nw))
    ng_split = torch.where(split, ng, torch.zeros_like(ng))
    q_first = torch.cumsum(ng_split, 0) - ng_split
    ends = torch.cumsum(ng, 0)
    b = torch.arange(n_table, device=dev)
    i = torch.searchsorted(ends, b, right=True)
    used = i < n
    i = torch.clamp(i, max=n - 1)
    g = b - (ends[i] - ng[i])
    sp = split[i]
    table = torch.stack([
        torch.where(used, o[i], torch.full_like(i, -1)),
        first[i] + g * group,
        torch.where(sp, torch.clamp(nw[i] - g * group, max=group), nw[i]),
        torch.where(sp, q_first[i] + g, torch.full_like(i, -1))],
        dim=1).to(torch.int32)
    # The rows of the groups after group 0, then the split tiles, each in
    # order (stable sorts of a 0/1 key).
    later = used & sp & (g > 0)
    j = torch.sort((~later).to(torch.int8), stable=True).indices[:n_extra]
    pass2 = torch.where(later[j, None], table[j], none)
    j = torch.sort((~split).to(torch.int8), stable=True).indices[:n_extra]
    combine = torch.stack([
        torch.where(split[j], o[j], torch.full_like(j, -1)), q_first[j],
        ng[j]], dim=1).to(torch.int32)
    if combine.shape[0] < n_extra:
        pad = torch.full((n_extra - combine.shape[0], 3), -1,
                         dtype=combine.dtype, device=dev)
        combine = torch.cat([combine, pad])
    return (table.contiguous(), pass2.contiguous(), combine.contiguous(),
            slots)


def slot_alpha(slots: torch.Tensor, counts: torch.Tensor,
               tiles: torch.Tensor, tiles_x: int):
    """The alpha test of C slot lists [C, 10, L] (``counts`` live) at the
    pixels of ``tiles``: (alpha, 0 where the test fails [C, 256, L]; ok,
    the test passed on a live slot [C, 256, L]; live [C, 1, L])."""
    ell = slots.shape[2]
    px, py = _tile_pixels(tiles, tiles_x)
    ch = lambda c: slots[:, c, None, :]                     # [C, 1, L]
    dx = px[:, :, None] - ch(0)                             # [C, 256, L]
    dy = py[:, :, None] - ch(1)
    power = -0.5 * (ch(2) * dx * dx + ch(4) * dy * dy) - ch(3) * dx * dy
    del dx, dy
    alpha = torch.clamp(ch(8) * torch.exp(torch.clamp(power, max=0.0)),
                        max=ALPHA_MAX)
    live = (torch.arange(ell, device=slots.device)[None, :]
            < counts[:, None])[:, None, :]
    ok = (power <= 0.0) & (alpha >= ALPHA_MIN) & live
    return torch.where(ok, alpha, torch.zeros_like(alpha)), ok, live


def _walk_from_plain(slots: torch.Tensor, counts: torch.Tensor,
                     tiles: torch.Tensor, tiles_x: int,
                     tlog0: torch.Tensor) -> torch.Tensor:
    """Plain walk of C slot lists [C, 10, L] (``counts`` live) entered
    with log T ``tlog0`` [C, 256] (the kernels' rules: a slot that passes
    the alpha test ends the walk, unincluded, where log T would fall below
    log(1e-4)).  Returns rows [C, 8, 256]: R, G, B, invdepth, alpha (no
    background), log T at the end, n_contrib, and 1.0 where it terminated.
    """
    alpha, ok, live = slot_alpha(slots, counts, tiles, tiles_x)
    ch = lambda c: slots[:, c, None, :]                     # [C, 1, L]
    lom = torch.log1p(-alpha)
    cum = torch.cumsum(torch.cat([tlog0[:, :, None], lom], dim=-1),
                       dim=-1)[..., 1:]
    fail = ok & (cum < LOG_EPS)
    include = (torch.cumsum(fail.to(torch.int32), dim=-1) == 0) & live
    w = torch.where(include & ok, alpha * torch.exp(cum - lom),
                    torch.zeros_like(alpha))
    rgb = torch.bmm(w, slots[:, 5:8, :].transpose(1, 2))    # [C, 256, 3]
    tlog = tlog0 + torch.sum(torch.where(include, lom,
                                         torch.zeros_like(lom)), dim=-1)
    return torch.stack([
        rgb[..., 0], rgb[..., 1], rgb[..., 2], torch.sum(w * ch(9), dim=-1),
        torch.sum(w, dim=-1), tlog, torch.sum(include, dim=-1).to(w.dtype),
        fail.any(dim=-1).to(w.dtype)], dim=1)


def blend_exact_split_plain(attrs: torch.Tensor, vcounts: torch.Tensor,
                            wt: torch.Tensor, last_v: torch.Tensor,
                            bg: torch.Tensor, tiles_x: int, t_mod: int = 0,
                            group: int | None = None) -> torch.Tensor:
    """Plain PyTorch twin of K3's window split (``csrc/blend_exact.cu``
    phases A, B and C, in its two passes) on the blocks of
    ``exact_split_plan`` (``group`` defaults to EXACT_GROUP): each group's
    drop in log T (group 0's from its own walk), each block's walk from the
    sum of its tile's earlier drops (dead on entry below log(1e-4)), and
    the per-tile combine.  For tests and the smoke's
    comparison; the render path does not use it.  Returns [T, 8, 256]."""
    group = EXACT_GROUP if group is None else group
    dev, k = attrs.device, attrs.shape[1]
    table, _, combine, _ = exact_split_plan(vcounts, wt, last_v, group)
    table = table[table[:, 0] >= 0].to(torch.int64)
    tile, v0, nw, q = table.unbind(1)
    out = torch.empty((last_v.shape[0], N_OUT, P), dtype=attrs.dtype,
                      device=dev)
    grp = q >= 0
    n_q = int(q.max()) + 1 if bool(grp.any()) else 0
    v_last = last_v.to(torch.int64)[tile]
    g = torch.where(grp, (v0 - (v_last - wt.to(torch.int64)[v_last]))
                    // max(group, 1), torch.zeros_like(v0))
    drop = torch.zeros((n_q, P), dtype=attrs.dtype, device=dev)
    part = torch.empty((n_q, N_OUT, P), dtype=attrs.dtype, device=dev)
    start = torch.zeros((table.shape[0], P), dtype=attrs.dtype, device=dev)

    def walk(rows_of):
        """B on the table rows ``rows_of`` from their ``start``."""
        for s, e, v, _, total in _run_chunks(vcounts, v0[rows_of],
                                             nw[rows_of], k, _PLAIN_ELEMS):
            r = rows_of[s:e]
            slots = attrs[v].reshape(e - s, -1, N_CH).transpose(1, 2)
            rows = _walk_from_plain(slots, total, _tile_mod(tile[r], t_mod),
                                    tiles_x, start[r])
            rows[:, 7] += 2.0 * (start[r] < LOG_EPS)
            whole = ~grp[r]
            out[tile[r][whole]] = _composite(rows[whole], bg)
            part[q[r][~whole]] = rows[~whole]
            # Group 0's drop: its end log T, or -inf where it terminated.
            first = grp[r] & (g[r] == 0)
            drop[q[r][first]] = torch.where(rows[first, 7] > 0,
                                            -math.inf, rows[first, OT])

    # Pass 1: tiles walked whole and every group 0; A for groups 1 .. ng-2.
    walk(torch.nonzero(g == 0).flatten())
    mid = torch.nonzero(grp & (g > 0) & (v0 + nw <= v_last)).flatten()
    for s, e, v, _, total in _run_chunks(vcounts, v0[mid], nw[mid], k,
                                         _PLAIN_ELEMS):
        slots = attrs[v].reshape(e - s, -1, N_CH).transpose(1, 2)
        drop[q[mid[s:e]]] = _drop_plain(slots, total,
                                        _tile_mod(tile[mid[s:e]], t_mod),
                                        tiles_x)
    # Pass 2: S_g, the tile's earlier drops in group order; B for g >= 1.
    for h in range(int(g.max()) if table.shape[0] else 0):
        more = g > h
        start[more] = start[more] + drop[(q - g + h)[more]]
    walk(torch.nonzero(g > 0).flatten())
    # C: each split tile's groups in order.
    combine = combine[combine[:, 0] >= 0].to(torch.int64)
    if combine.shape[0]:
        t_c, q0, ng = combine.unbind(1)
        acc = torch.zeros((t_c.shape[0], N_OUT, P), dtype=attrs.dtype,
                          device=dev)
        going = torch.ones((t_c.shape[0], P), dtype=torch.bool, device=dev)
        for h in range(int(ng.max())):
            p = part[torch.clamp(q0 + h, max=n_q - 1)]
            take = going & (h < ng)[:, None]
            for r in (OR, OG, OB, OI, OA, ON):
                acc[:, r] = torch.where(take, acc[:, r] + p[:, r], acc[:, r])
            alive_in = take & (p[:, 7] < 2.0)
            acc[:, OT] = torch.where(alive_in, p[:, OT], acc[:, OT])
            going = going & ~(take & ((p[:, 7] == 1.0) | (p[:, 7] == 3.0)))
        out[t_c] = _composite(acc, bg)
    return out


def _tile_mod(tiles: torch.Tensor, t_mod: int) -> torch.Tensor:
    return tiles % t_mod if t_mod else tiles


def _drop_plain(slots: torch.Tensor, counts: torch.Tensor,
                tiles: torch.Tensor, tiles_x: int) -> torch.Tensor:
    """Phase A of the split: per pixel the sum, in slot order, of
    log1p(-alpha) over the live slots that pass the alpha test [C, 256]."""
    lom = torch.log1p(-slot_alpha(slots, counts, tiles, tiles_x)[0])
    return torch.cumsum(lom, dim=-1)[..., -1]


def _composite(rows: torch.Tensor, bg: torch.Tensor) -> torch.Tensor:
    """Partial rows [C, 8, 256] -> output rows: background under the final
    transmittance, pad row 0."""
    out = rows.clone()
    tf = torch.exp(rows[:, OT])
    for c in range(3):
        out[:, c] = rows[:, c] + tf * bg.reshape(-1)[c]
    out[:, 7] = 0.0
    return out


def _rev_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix sum along the last axis."""
    return torch.flip(torch.cumsum(torch.flip(x, (-1,)), -1), (-1,))


def _blend_slots_bwd_plain(attrs: torch.Tensor, counts: torch.Tensor,
                           tiles: torch.Tensor, tiles_x: int,
                           bg: torch.Tensor, saved: torch.Tensor,
                           g_out: torch.Tensor) -> torch.Tensor:
    """Plain backward of C tiles (the formulas of K2/K4, blend_bwd.cuh):
    attrs [C, 10, L] with ``counts`` [C] live slots, bg [C, 3], the saved
    forward rows and their cotangent [C, 8, 256].  Slot k of a pixel counts
    when k < its saved n_contrib; the log transmittance before slot k is
    rebuilt from the saved final log T minus the suffix sum of
    log(1 - alpha) from k on.  Returns per-slot grads [C, 10, L]."""
    ell = attrs.shape[2]
    px, py = _tile_pixels(tiles, tiles_x)
    ch = lambda c: attrs[:, c, None, :]                     # [C, 1, L]
    dx = px[:, :, None] - ch(0)                             # [C, 256, L]
    dy = py[:, :, None] - ch(1)
    power = -0.5 * (ch(2) * dx * dx + ch(4) * dy * dy) - ch(3) * dx * dy
    expp = torch.exp(torch.clamp(power, max=0.0))
    raw = ch(8) * expp
    alpha = torch.clamp(raw, max=ALPHA_MAX)
    k = torch.arange(ell, device=attrs.device)
    live = (k[None, :] < counts[:, None])[:, None, :]       # [C, 1, L]
    include = (k[None, None, :].to(torch.float32)
               < saved[:, ON, :, None]) & live              # [C, 256, L]
    ok = (power <= 0.0) & (alpha >= ALPHA_MIN) & include
    del power
    zero = torch.zeros_like(alpha)
    alpha = torch.where(ok, alpha, zero)
    lom = torch.log1p(-alpha)
    t_excl = torch.exp(saved[:, OT, :, None] - _rev_cumsum(lom))
    del lom
    w = alpha * t_excl
    g = lambda r: g_out[:, r, :, None]                      # [C, 256, 1]
    pg = g(OR) * ch(5) + g(OG) * ch(6) + g(OB) * ch(7) + g(OI) * ch(9) + g(OA)
    wpg = w * pg
    # Strict suffix: the slots behind k.
    suffix = torch.cat([_rev_cumsum(wpg)[..., 1:], zero[..., :1]], dim=-1)
    del wpg
    g_tfinal = ((g_out[:, OR] * bg[:, 0:1] + g_out[:, OG] * bg[:, 1:2]
                 + g_out[:, OB] * bg[:, 2:3])
                * torch.exp(saved[:, OT]))[:, :, None]      # [C, 256, 1]
    one_m = torch.clamp(1.0 - alpha, min=1e-4)
    g_alpha = torch.where(ok & (raw < ALPHA_MAX),
                          t_excl * pg - (suffix + g_tfinal) / one_m, zero)
    del t_excl, pg, suffix, one_m, raw
    g_power = alpha * g_alpha
    col = lambda x: torch.sum(x, dim=1)                      # [C, L]
    return torch.stack([
        col(g_power * (ch(2) * dx + ch(3) * dy)),
        col(g_power * (ch(4) * dy + ch(3) * dx)),
        col(g_power * (-0.5 * dx * dx)),
        col(g_power * (-dx * dy)),
        col(g_power * (-0.5 * dy * dy)),
        col(g(OR) * w), col(g(OG) * w), col(g(OB) * w),
        col(expp * g_alpha),
        col(w * g(OI))], dim=1)


def blend_padded_bwd_plain(attrs: torch.Tensor, counts: torch.Tensor,
                           bg: torch.Tensor, saved: torch.Tensor,
                           g_out: torch.Tensor, tiles_x: int, tile0: int = 0,
                           t_mod: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K2 (same arguments and result as
    ``blend_padded_bwd``), in chunks of tiles."""
    t, _, k = attrs.shape
    out = torch.empty_like(attrs)
    step = max(1, _PLAIN_BWD_ELEMS // (P * max(k, 1)))
    counts = torch.clamp(counts, max=k)
    for s in range(0, t, step):
        e = min(t, s + step)
        tiles = torch.arange(s, e, device=attrs.device) + tile0
        if t_mod:
            tiles = tiles % t_mod
        bg_c = bg[s:e] if bg.shape[0] != 1 else bg.expand(e - s, 3)
        out[s:e] = _blend_slots_bwd_plain(attrs[s:e], counts[s:e], tiles,
                                          tiles_x, bg_c, saved[s:e],
                                          g_out[s:e])
    return out


def blend_exact_bwd_plain(attrs: torch.Tensor, vcounts: torch.Tensor,
                          wt: torch.Tensor, last_v: torch.Tensor,
                          bg: torch.Tensor, saved: torch.Tensor,
                          g_out: torch.Tensor, tiles_x: int,
                          t_mod: int = 0,
                          order: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of K4 (same arguments and result as
    ``blend_exact_bwd``): each real tile's windows as one slot list, as in
    ``blend_exact_plain``, and the slot grads put back into their windows.
    Budget windows no tile uses, and with ``order`` the windows of the
    tiles left out of it, stay zero."""
    _, k, _ = attrs.shape
    tiles = _order_tiles(last_v, order)
    out = torch.zeros_like(attrs)
    for s, e, v, valid, total in _exact_chunks(vcounts, wt, last_v[tiles], k,
                                               _PLAIN_BWD_ELEMS):
        tt = tiles[s:e]
        slots = attrs[v].reshape(e - s, -1, N_CH).transpose(1, 2)
        d = _blend_slots_bwd_plain(
            slots, total, _tile_mod(tt, t_mod), tiles_x,
            bg.expand(e - s, 3), saved[tt], g_out[tt])
        d = d.transpose(1, 2).reshape(e - s, -1, k, N_CH)
        out[v[valid]] = d[valid]
    return out


def background_grad(saved: torch.Tensor, g_out: torch.Tensor,
                    per_tile: bool) -> torch.Tensor:
    """d loss / d bg of a blend (outside the kernel, as
    ``pallas_blend.py:863-868``): sum over pixels of T_final * g_rgb, per
    tile [T, 3] or summed [1, 3]."""
    t_final = torch.exp(saved[:, OT])                       # [T, 256]
    per = torch.sum(t_final[:, None, :] * g_out[:, OR:OB + 1], dim=2)
    return per if per_tile else torch.sum(per, dim=0, keepdim=True)


def blend_padded_bwd(attrs: torch.Tensor, counts: torch.Tensor,
                     bg: torch.Tensor, saved: torch.Tensor,
                     g_out: torch.Tensor, tiles_x: int, tile0: int = 0,
                     t_mod: int = 0) -> torch.Tensor:
    """K2.  The inputs of K1 plus its saved output and the cotangent
    ``g_out`` [T, 8, 256] f32.  Returns the per-slot grads [T, 10, K]
    (zeros past the count).  Launches ``csrc/blend_padded_bwd.cu`` on CUDA
    tensors; runs ``blend_padded_bwd_plain`` on CPU tensors."""
    dev = attrs.device
    t, _, k = attrs.shape
    for name, x in (("saved", saved), ("g_out", g_out)):
        _check(x, name, torch.float32, 3, dev)
        if tuple(x.shape) != (t, N_OUT, P):
            raise ValueError(f"blend_padded_bwd: {name} has shape "
                             f"{tuple(x.shape)}, expected {(t, N_OUT, P)}")
    if not _kernel_device(attrs, "blend_padded_bwd"):
        return blend_padded_bwd_plain(attrs, counts, bg, saved, g_out,
                                      tiles_x, tile0, t_mod)
    d = torch.empty_like(attrs)
    native.launch("blend_padded_bwd", attrs.data_ptr(), counts.data_ptr(),
                  bg.data_ptr(), int(bg.shape[0] != 1), t, k, tiles_x, tile0,
                  t_mod, saved.data_ptr(), g_out.data_ptr(), d.data_ptr())
    return d


def exact_tile_order(wt: torch.Tensor, last_v: torch.Tensor) -> torch.Tensor:
    """K4's launch order: the real tiles [T] int32 by window count
    (``wt[last_v] + 1``), deepest first, ties in tile order (a stable
    sort), so the tiles with the most windows do not start last."""
    windows = wt[last_v.to(torch.int64)] + 1
    order = torch.sort(windows, descending=True, stable=True).indices
    return order.to(torch.int32)


def _check_order(order: torch.Tensor, t: int, what: str,
                 device: torch.device) -> None:
    """An order is distinct real-tile ids in [0, t): the kernels index
    the layout with them and size their tables from t.  (The range and
    distinctness checks read the order back to the host.)"""
    _check(order, "order", torch.int32, 1, device)
    if order.shape[0] > t:
        raise ValueError(f"{what}: order has {order.shape[0]} entries for "
                         f"{t} tiles")
    if order.shape[0] and (int(order.min()) < 0 or int(order.max()) >= t
                           or torch.unique(order).shape[0]
                           != order.shape[0]):
        raise ValueError(f"{what}: order must hold distinct tile ids in "
                         f"[0, {t})")


def blend_exact_bwd(attrs: torch.Tensor, vcounts: torch.Tensor,
                    wt: torch.Tensor, last_v: torch.Tensor, bg: torch.Tensor,
                    saved: torch.Tensor, g_out: torch.Tensor, tiles_x: int,
                    t_mod: int = 0,
                    order: torch.Tensor | None = None) -> torch.Tensor:
    """K4.  The inputs of K3 plus its saved per-real-tile output and the
    cotangent ``g_out`` [T, 8, 256] f32.  Returns the pair-major per-slot
    grads [T_v, K, 10] (zeros past each window's count and in budget
    windows no tile uses).  Launches ``csrc/blend_exact_bwd.cu`` on CUDA
    tensors, one block per entry of ``order`` (int32 real-tile ids;
    ``exact_tile_order`` when not given): a tile left out gets no grads, and
    the order changes no tile's grads.  Runs ``blend_exact_bwd_plain`` on
    CPU tensors, over the tiles of ``order`` alike."""
    dev = attrs.device
    t = last_v.shape[0]
    for name, x in (("saved", saved), ("g_out", g_out)):
        _check(x, name, torch.float32, 3, dev)
        if tuple(x.shape) != (t, N_OUT, P):
            raise ValueError(f"blend_exact_bwd: {name} has shape "
                             f"{tuple(x.shape)}, expected {(t, N_OUT, P)}")
    if order is not None:
        _check_order(order, t, "blend_exact_bwd", dev)
    if not _kernel_device(attrs, "blend_exact_bwd"):
        return blend_exact_bwd_plain(attrs, vcounts, wt, last_v, bg, saved,
                                     g_out, tiles_x, t_mod, order)
    return blend_exact_bwd_launch(attrs, vcounts, wt, last_v, bg, saved,
                                  g_out, tiles_x, t_mod, order)


def blend_exact_bwd_launch(attrs: torch.Tensor, vcounts: torch.Tensor,
                           wt: torch.Tensor, last_v: torch.Tensor,
                           bg: torch.Tensor, saved: torch.Tensor,
                           g_out: torch.Tensor, tiles_x: int, t_mod: int,
                           order: torch.Tensor | None) -> torch.Tensor:
    """Launch K4 (``csrc/blend_exact_bwd.cu``) on checked CUDA tensors
    over the real tiles of ``order`` (``exact_tile_order`` when None), with
    no host read; returns the grads."""
    if order is None:
        order = exact_tile_order(wt, last_v)
    d = torch.zeros_like(attrs)
    native.launch("blend_exact_bwd", attrs.data_ptr(), vcounts.data_ptr(),
                  wt.data_ptr(), last_v.data_ptr(), order.data_ptr(),
                  bg.data_ptr(), order.shape[0], attrs.shape[1], tiles_x,
                  t_mod, saved.data_ptr(), g_out.data_ptr(), d.data_ptr())
    return d


def blend_exact_launch(attrs: torch.Tensor, vcounts: torch.Tensor,
                       wt: torch.Tensor, last_v: torch.Tensor,
                       bg: torch.Tensor, tiles_x: int, t_mod: int,
                       order: torch.Tensor | None,
                       group: int) -> torch.Tensor:
    """Launch K3 (``csrc/blend_exact.cu``: the plan, pass 1 and, where
    the shapes allow a split, pass 2 and the combine) on checked CUDA
    tensors over the real tiles of ``order`` (all, in tile order, when
    None) with windows split in groups of ``group`` (0: no split).
    Allocates the block tables (which the kernel fills), the scratch for
    the split's drops and partial rows, and the [T, 8, 256] output (rows
    of tiles left out of ``order`` not written), which it returns."""
    t = last_v.shape[0]
    n = t if order is None else order.shape[0]
    sc = exact_scratch(n, vcounts.shape[0], t, group, attrs.device)
    native.launch("blend_exact", attrs.data_ptr(), vcounts.data_ptr(),
                  wt.data_ptr(), last_v.data_ptr(),
                  None if order is None else order.data_ptr(), n,
                  bg.data_ptr(), attrs.shape[1], group, tiles_x, t_mod,
                  *sc.pointers(), sc.out.data_ptr())
    return sc.out


class ExactScratch(NamedTuple):
    """What a launch of K3's kernels (``csrc/blend_exact.cuh``) writes
    besides its input: the block tables, which its plan kernel fills, the
    split's drops and partial rows, and the [T, 8, 256] output."""
    table: torch.Tensor       # [n_table, 4] int32
    pass2: torch.Tensor       # [n_extra, 4] int32
    combine: torch.Tensor     # [n_extra, 3] int32
    drop: torch.Tensor        # [slots, 256] f32
    part: torch.Tensor        # [slots, 8, 256] f32
    out: torch.Tensor         # [T, 8, 256] f32

    def pointers(self) -> tuple:
        """The C arguments table, n_table, pass2, combine, n_extra, drop,
        part."""
        return (self.table.data_ptr(), self.table.shape[0],
                self.pass2.data_ptr(), self.combine.data_ptr(),
                self.pass2.shape[0], self.drop.data_ptr(),
                self.part.data_ptr())


def exact_scratch(n: int, nv: int, t: int, group: int,
                  dev: torch.device) -> ExactScratch:
    """Uninitialised buffers of a launch of K3's kernels over ``n`` of the
    ``t`` real tiles of ``nv`` windows, sized from the shapes alone
    (``_split_sizes``)."""
    n_table, n_extra, slots = _split_sizes(n, nv, t, group)
    f32, i32 = torch.float32, torch.int32
    return ExactScratch(
        torch.empty((n_table, 4), dtype=i32, device=dev),
        torch.empty((n_extra, 4), dtype=i32, device=dev),
        torch.empty((n_extra, 3), dtype=i32, device=dev),
        torch.empty((slots, P), dtype=f32, device=dev),
        torch.empty((slots, N_OUT, P), dtype=f32, device=dev),
        torch.empty((t, N_OUT, P), dtype=f32, device=dev))


class _BlendPadded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, attrs, counts, bg, tiles_x, tile0, t_mod):
        t, _, k = attrs.shape
        if _kernel_device(attrs, "blend_padded"):
            out = torch.empty((t, N_OUT, P), dtype=torch.float32,
                              device=attrs.device)
            native.launch("blend_padded", attrs.data_ptr(),
                          counts.data_ptr(), bg.data_ptr(),
                          int(bg.shape[0] != 1), t, k, tiles_x, tile0, t_mod,
                          out.data_ptr())
        else:
            out = blend_padded_plain(attrs, counts, bg, tiles_x, tile0,
                                     t_mod)
        ctx.save_for_backward(attrs, counts, bg, out)
        ctx.grid = (tiles_x, tile0, t_mod)
        return out

    @staticmethod
    def backward(ctx, g_out):
        attrs, counts, bg, saved = ctx.saved_tensors
        g_out = g_out.to(torch.float32).contiguous()
        d = blend_padded_bwd(attrs, counts, bg, saved, g_out, *ctx.grid)
        g_bg = background_grad(saved, g_out, bg.shape[0] != 1)
        return d, None, g_bg, None, None, None


def _outside(order: torch.Tensor, t: int) -> torch.Tensor:
    """[t, 1, 1] bool: the tiles left out of ``order``."""
    out = torch.ones((t,), dtype=torch.bool, device=order.device)
    out[order.to(torch.int64)] = False
    return out[:, None, None]


class _BlendExact(torch.autograd.Function):
    """K3 under autograd, K4 its backward.  With ``order`` (a rank's tiles)
    the rows of the other tiles are zero, their cotangent is dropped and
    K4 walks the tiles of ``order`` alone, so neither the saved rows nor
    the grads of another rank's windows enter anything summed."""

    @staticmethod
    def forward(ctx, attrs, vcounts, wt, last_v, bg, tiles_x, t_mod, order):
        if _kernel_device(attrs, "blend_exact"):
            out = blend_exact_launch(attrs, vcounts, wt, last_v, bg, tiles_x,
                                     t_mod, order, EXACT_GROUP)
            if order is not None:
                out.masked_fill_(_outside(order, out.shape[0]), 0.0)
        else:
            out = blend_exact_plain(attrs, vcounts, wt, last_v, bg, tiles_x,
                                    t_mod, order)
        ctx.save_for_backward(attrs, vcounts, wt, last_v, bg, out, order)
        ctx.grid = (tiles_x, t_mod)
        return out

    @staticmethod
    def backward(ctx, g_out):
        with span("blend.k4"):
            attrs, vcounts, wt, last_v, bg, saved, order = ctx.saved_tensors
            g_out = g_out.to(torch.float32).contiguous()
            if order is not None:
                g_out = g_out.masked_fill(_outside(order, g_out.shape[0]),
                                          0.0)
            d = blend_exact_bwd(attrs, vcounts, wt, last_v, bg, saved, g_out,
                                *ctx.grid, order=order)
            g_bg = background_grad(saved, g_out, False)
        return d, None, None, None, g_bg, None, None, None


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
                t_mod: int = 0,
                order: torch.Tensor | None = None) -> torch.Tensor:
    """K3.  attrs [T_v, K, 10] f32 pair-major over virtual tiles; vcounts,
    wt [T_v] and last_v [T] int32 from exact-mode ``TileBins``; bg [1, 3].
    Returns [T, 8, 256] per real tile.  On CUDA tensors the kernel takes
    the real tiles in tile order, or those of ``order`` (distinct int32
    tile ids) in that order: a tile left out gets zero rows and no grads
    (its cotangent is dropped), and the order changes no tile's rows.  On
    CPU tensors ``blend_exact_plain`` runs, over the tiles of ``order``
    alike."""
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
    if order is not None:
        _check_order(order, last_v.shape[0], "blend_exact", dev)
    return _BlendExact.apply(attrs, vcounts, wt, last_v, bg, int(tiles_x),
                             int(t_mod), order)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def slot_grads_to_rows(d_slots: torch.Tensor, ids: torch.Tensor, m: int,
                       seg_pos: torch.Tensor | None = None,
                       grad_sort: str = "f32") -> torch.Tensor:
    """The backward of the slot gather (``_gather_pack_bwd``,
    ``pallas_blend.py:1000-1081``): per-slot grads ``d_slots`` [P, C] of
    slot ids ``ids`` [P] (sentinel ``m`` for masked slots) summed into rows
    [m, C].  The slots are sorted by id (stable) and each row's segment is
    summed in f32.  Segments come from ``seg_pos`` [m + 1] (the per-rank
    emitted-pair prefix, ``grad_reduce="counts"``; sound only at
    ``tile_overflow == 0``, as in JAX) or, without it, from the sorted ids
    themselves.  ``grad_sort="bf16"`` rounds each slot's grad to bf16 before
    the sum, as the JAX packed sort does."""
    with span("blend.slot_grads"):
        sorted_ids, perm = torch.sort(ids.reshape(-1), stable=True)
        vals = d_slots[perm]
        if grad_sort == "bf16":
            vals = _round_bf16(vals)
        if seg_pos is None:
            offsets = torch.searchsorted(
                sorted_ids, torch.arange(m + 1, dtype=sorted_ids.dtype,
                                         device=ids.device))
        else:
            # Clamped so that an overflowing counts step (whose update the
            # train step reverts) cannot index past the slots.
            offsets = torch.clamp(seg_pos, max=vals.shape[0])
        return torch.segment_reduce(vals, "sum",
                                    offsets=offsets.to(torch.int64),
                                    axis=0, unsafe=True)


class _GatherPack(torch.autograd.Function):
    """``rows[gather]`` ([M, 10] -> [T, K, 10], channel-major [T, 10, K]
    unless ``pair_major``) whose backward is ``slot_grads_to_rows``."""

    @staticmethod
    def forward(ctx, attrs_n, gather, seg_pos, grad_sort, pair_major, bf16):
        rows = torch.cat([attrs_n, attrs_n.new_zeros((1, N_CH))])
        out = rows[gather.to(torch.int64)]                   # [T, K, 10]
        ctx.save_for_backward(gather, seg_pos)
        ctx.cfg = (attrs_n.shape[0], grad_sort, pair_major, bf16)
        return out if pair_major else out.transpose(1, 2).contiguous()

    @staticmethod
    def backward(ctx, d):
        gather, seg_pos = ctx.saved_tensors
        m, grad_sort, pair_major, bf16 = ctx.cfg
        d2 = (d if pair_major else d.transpose(1, 2)).reshape(-1, N_CH)
        if bf16:
            # The slot grads and row sums at the attrs' precision, as the
            # JAX kernels' bf16 outputs and its ``astype(d.dtype)``.
            d2 = _round_bf16(d2)
        rows = slot_grads_to_rows(d2.to(torch.float32), gather, m, seg_pos,
                                  grad_sort)
        if bf16:
            rows = _round_bf16(rows)
        return rows, None, None, None, None, None


def pack_gather_attrs(gather, mean2d, conic, color, opacity, inv_depth,
                      dtype=torch.float32, order=None, rank=None,
                      grad_sort="f32", seg_pos=None,
                      pair_major=False) -> torch.Tensor:
    """[N, ·] attributes + [T, K] depth-rank table -> packed kernel input:
    channel-major [T, 10, K], or pair-major [T, K, 10] for the exact kernel.

    With ``order``/``rank`` (``TileBins.order`` / ``TileBins.rank``) the
    [N, 10] rows are moved into depth order first (``permute_rows``, whose
    backward is the inverse gather); sentinel ranks (masked slots) read an
    appended zero row.  ``dtype=bfloat16`` rounds the payload to bf16 and
    back: the TPU kernel upcasts on load, so this is its numerics, blended
    in f32; the backward rounds the slot grads and row sums to bf16 too.
    The backward of the gather is ``slot_grads_to_rows`` with ``seg_pos``
    and ``grad_sort``."""
    attrs_n = torch.cat([mean2d, conic, color, opacity[:, None],
                         inv_depth[:, None]], dim=1).to(torch.float32)
    bf16 = dtype == torch.bfloat16
    if bf16:
        attrs_n = _round_bf16(attrs_n)
    if order is not None:
        attrs_n = permute_rows(attrs_n, order, rank)
    return _GatherPack.apply(attrs_n, gather, seg_pos, grad_sort, pair_major,
                             bf16)


def _to_image(flat: torch.Tensor, tiles_x: int, tiles_y: int, height: int,
              width: int) -> torch.Tensor:
    ch = flat.shape[1]
    img = flat.reshape(tiles_y, tiles_x, ch, TILE, TILE)
    img = img.permute(2, 0, 3, 1, 4).reshape(ch, tiles_y * TILE,
                                             tiles_x * TILE)
    return img[:, :height, :width]


def image_outputs(flat: torch.Tensor, tiles_x: int, tiles_y: int, h: int,
                  w: int) -> dict:
    """Packed rows [T, 8, 256] of one view (at least its ``tiles_x *
    tiles_y`` tiles) -> render [3,H,W], depth [1,H,W], alpha [H,W]."""
    t = tiles_x * tiles_y
    if flat.shape[0] != t:        # a full slice still adds a backward node
        flat = flat[:t]
    return {"render": _to_image(flat[:, OR:OB + 1], tiles_x, tiles_y, h, w),
            "depth": _to_image(flat[:, OI:OI + 1], tiles_x, tiles_y, h, w),
            "alpha": _to_image(flat[:, OA:OA + 1], tiles_x, tiles_y, h,
                               w)[0]}


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
    """Blend of binned tiles through K1 (padded) or K3 (exact mode, when
    ``bins.t_of_v`` is set), differentiable through K2 / K4.  Returns
    (image [3,H,W], invdepth [1,H,W], alpha [H,W]).  ``grad_sort`` shapes
    the slot->row reduction (``slot_grads_to_rows``), which takes its
    segments from ``bins.seg_pos`` when binning made them.  ``tile_batch``
    is a TPU knob, accepted for interface parity; it changes nothing
    here."""
    with span("blend.k3"):
        tiles_x, tiles_y = bins.tiles_x, bins.tiles_y
        k_cap = bins.gather.shape[1]
        if k_cap % 128 != 0:
            raise ValueError(f"tile_capacity must be a multiple of 128, "
                             f"got {k_cap}")
        exact = bins.t_of_v is not None
        attrs = pack_gather_attrs(bins.gather, mean2d, conic, color, opacity,
                                  inv_depth, dtype=attr_dtype,
                                  order=bins.order, rank=bins.rank,
                                  grad_sort=grad_sort, seg_pos=bins.seg_pos,
                                  pair_major=exact)
        bg2 = bg.reshape(1, 3).to(torch.float32).contiguous()
        if exact:
            out = blend_exact(attrs, bins.vcounts, bins.wt, bins.last_v, bg2,
                              tiles_x)
        else:
            out = blend_padded(attrs, bins.counts.to(torch.int32).contiguous(),
                               bg2, tiles_x)
        res = image_outputs(out, tiles_x, tiles_y, height, width)
        return res["render"], res["depth"], res["alpha"]
