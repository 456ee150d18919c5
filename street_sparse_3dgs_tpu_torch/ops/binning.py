"""Tile binning: assign depth-sorted Gaussians to 16×16 pixel tiles.

Mirrors ``street_sparse_3dgs_tpu/ops/binning.py`` table for table: the same
pair emission (ellipse culling, overscan compaction, the ``DUP_TAILS``
ladder), the same per-tile depth-rank tables, counters and exact-mode
window allocation, so the port's ``TileBins`` equal the JAX ones element by
element.  What differs is only how the GPU gets there:

- the depth order is a stable ``torch.sort`` (culled rows tie at +inf);
- the slot scan and its per-row compaction (JAX: [N, S] slot math, then a
  per-row sort) are one kernel, ``bin_scan`` (``csrc/bin_scan.cu``), on
  CUDA tensors: a row's kept tile ids rise with the slot index, so
  compacting them in slot order gives the sorted row without a sort;
- pair keys pack ``tile << rank_bits | rank`` into int64, so one sort of
  unique keys serves every JAX ``key_mode`` (the lexicographic fallback the
  TPU needs for keys over 32 bits is not needed);
- tile boundaries and the exact-mode window lookup use
  ``torch.searchsorted``;
- the ``[T, K]`` table is built by kernel K5 (``csrc/slab_gather.cu``) on
  CUDA tensors, and by its plain version on the CPU.

Binning builds integer tables only: it runs under ``torch.no_grad()`` on
detached inputs (JAX's ``stop_gradient``), so autograd keeps none of the
``[N, S]`` emission temporaries alive through a training step.
``with_seg_pos`` adds the per-rank emitted-pair prefix that the
counts-based backward segments by.  ``permute_rows`` moves attribute rows
into depth order with the inverse gather as its backward.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import native
from ..profiling import count, span, sync_point
from .oracle import ALPHA_MIN
from .preprocess import Projected

TILE = 16
KEY_MODES = (None, "packed31", "packed32", "lex")

# Rect positions evaluated per gaussian, as a multiple of max_dup.
DUP_OVERSCAN = 4

# Tail buckets (budget, extra_width) for gaussians whose surviving-tile
# count exceeds max_dup (see the JAX module for how they were sized).
DUP_TAILS: tuple[tuple[int, int], ...] = ((8192, 32), (512, 96))

# Past a row's kept tiles in ``bin_scan``'s table.
TILE_SENTINEL = 2 ** 31 - 1


class TileBins(NamedTuple):
    order: torch.Tensor       # [M] depth-sort permutation: order[r] = row of rank r
    rank: torch.Tensor        # [N] depth rank of row i (== M if compacted away)
    gather: torch.Tensor      # [T, K] depth ranks ([T_v, K] in exact mode)
    mask: torch.Tensor        # [T, K] bool validity ([T_v, K] in exact mode)
    counts: torch.Tensor      # [T] pairs binned per tile (pre-clip)
    dup_overflow: torch.Tensor   # scalar: tiles lost to the per-gaussian cap
    tile_overflow: torch.Tensor  # scalar: pairs lost to the per-tile cap
    tiles_x: int
    tiles_y: int
    vis_overflow: torch.Tensor | int = 0  # visible rows dropped past vis_capacity
    # Exact ("virtual tile") mode, ``exact_extra > 0``; None otherwise.
    t_of_v: torch.Tensor | None = None   # [T_v] real tile of each window (T if unused)
    wt: torch.Tensor | None = None       # [T_v] window index within its tile
    last_v: torch.Tensor | None = None   # [T] last window of each real tile
    vcounts: torch.Tensor | None = None  # [T_v] pairs in this window (<= K)
    # [M+1] int32 exclusive prefix of per-rank emitted pairs
    # (``with_seg_pos``): rank r's slots occupy [seg_pos[r], seg_pos[r+1])
    # of the id-sorted slot list while tile_overflow == 0.
    seg_pos: torch.Tensor | None = None


class _PermuteRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, order, inv_order):
        ctx.save_for_backward(inv_order)
        return x[order.to(torch.int64)]

    @staticmethod
    def backward(ctx, g):
        (inv_order,) = ctx.saved_tensors
        gpad = torch.cat([g, g.new_zeros((1,) + g.shape[1:])])
        return gpad[inv_order.to(torch.int64)], None, None


def permute_rows(x: torch.Tensor, order: torch.Tensor,
                 inv_order: torch.Tensor) -> torch.Tensor:
    """``x[order]`` whose backward is the inverse gather ``g[inv_order]``
    (not a scatter; exact because ``order`` is a permutation).  ``order``
    may be a slice of a permutation (visible compaction, len V): rows left
    out carry ``inv_order == V`` and get a zero grad."""
    return _PermuteRows.apply(x, order, inv_order)


def num_tiles(height: int, width: int) -> tuple[int, int]:
    return (-(-width // TILE), -(-height // TILE))


def _tile_index(x: torch.Tensor, hi: int) -> torch.Tensor:
    # NaN -> 0 as XLA's float->int conversion does; clamp then truncate.
    return torch.clamp(torch.floor(torch.nan_to_num(x, nan=0.0) / TILE),
                       0, hi).to(torch.int32)


def tile_rect(mean2d: torch.Tensor, radius: torch.Tensor,
              tiles_x: int, tiles_y: int):
    """Covered tile rectangle per Gaussian, exclusive max (CUDA ``getRect``
    semantics), clamped to the grid.  Returns int32 (x0, y0, x1, y1)."""
    x0 = _tile_index(mean2d[:, 0] - radius, tiles_x)
    y0 = _tile_index(mean2d[:, 1] - radius, tiles_y)
    x1 = _tile_index(mean2d[:, 0] + radius + TILE - 1, tiles_x)
    y1 = _tile_index(mean2d[:, 1] + radius + TILE - 1, tiles_y)
    return x0, y0, torch.maximum(x1, x0), torch.maximum(y1, y0)


def slab_gather_plain(sorted_vals: torch.Tensor, starts: torch.Tensor,
                      counts: torch.Tensor, k_cap: int, rank_bits: int,
                      sentinel: int) -> torch.Tensor:
    """Plain PyTorch version of K5 (same arguments and result as
    ``slab_gather``): ``padded[starts[:, None] + arange(K)]``, then the
    rank extraction and the sentinel for slots past min(count, K)."""
    dev = sorted_vals.device
    padded = torch.cat([sorted_vals,
                        torch.zeros(k_cap, dtype=sorted_vals.dtype,
                                    device=dev)])
    k = torch.arange(k_cap, device=dev)
    table = padded[starts.to(torch.int64)[:, None] + k[None, :]]
    live = k[None, :] < torch.clamp(counts, max=k_cap)[:, None]
    ranks = (table & ((1 << rank_bits) - 1)).to(torch.int32)
    return torch.where(live, ranks, torch.full_like(ranks, sentinel))


def slab_gather(sorted_vals: torch.Tensor, starts: torch.Tensor,
                counts: torch.Tensor, k_cap: int, rank_bits: int,
                sentinel: int) -> torch.Tensor:
    """K5: the [T, K] int32 table of depth ranks.  ``sorted_vals`` [M] int64
    packed keys (rank in the low ``rank_bits``), ``starts``/``counts`` [T]
    int32 per-tile segments.  Slot k of tile t holds the rank of
    ``sorted_vals[starts[t] + k]`` when k < min(counts[t], K), else
    ``sentinel``.  Launches ``csrc/slab_gather.cu`` on CUDA tensors; runs
    ``slab_gather_plain`` on CPU tensors."""
    dev = sorted_vals.device
    for name, x, dt in (("sorted_vals", sorted_vals, torch.int64),
                        ("starts", starts, torch.int32),
                        ("counts", counts, torch.int32)):
        if x.dtype != dt or x.dim() != 1 or not x.is_contiguous() or \
                x.device != dev:
            raise ValueError(f"slab_gather: {name} must be a contiguous 1-d "
                             f"{dt} tensor on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    t = starts.shape[0]
    if counts.shape[0] != t:
        raise ValueError("slab_gather: starts and counts differ in shape")
    if not sorted_vals.is_cuda:
        if dev.type == "cpu":
            return slab_gather_plain(sorted_vals, starts, counts, k_cap,
                                     rank_bits, sentinel)
        raise RuntimeError(f"slab_gather: no kernel for {dev}")
    out = torch.empty((t, k_cap), dtype=torch.int32, device=dev)
    native.launch("slab_gather", sorted_vals.data_ptr(), starts.data_ptr(),
                  counts.data_ptr(), t, k_cap, (1 << rank_bits) - 1,
                  sentinel, out.data_ptr())
    return out


def _tile_qmin(mean2d, conic, tile_x, tile_y):
    """Minimum of Q(d) = a·dx² + 2b·dx·dy + c·dy² over each (gaussian,
    covered-tile) pair's pixel box [N, S] — a conservative bound that lets
    binning drop pairs whose best alpha stays under 1/255."""
    a = conic[:, 0:1]
    b = conic[:, 1:2]
    c = conic[:, 2:3]
    inv_a = 1.0 / a
    inv_c = 1.0 / c
    dxl = (tile_x * TILE).to(torch.float32) - mean2d[:, 0:1]
    dxr = dxl + (TILE - 1)
    dyb = (tile_y * TILE).to(torch.float32) - mean2d[:, 1:2]
    dyt = dyb + (TILE - 1)
    inside = (dxl <= 0) & (dxr >= 0) & (dyb <= 0) & (dyt >= 0)

    def edge_x(x):
        dy = torch.minimum(torch.maximum(-b * x * inv_c, dyb), dyt)
        return a * x * x + 2.0 * b * x * dy + c * dy * dy

    def edge_y(y):
        dx = torch.minimum(torch.maximum(-b * y * inv_a, dxl), dxr)
        return a * dx * dx + 2.0 * b * dx * y + c * y * y

    q = torch.minimum(torch.minimum(edge_x(dxl), edge_x(dxr)),
                      torch.minimum(edge_y(dyb), edge_y(dyt)))
    return torch.where(inside, torch.zeros_like(q), q)


def slot_tiles(x0: torch.Tensor, y0: torch.Tensor, nx: torch.Tensor,
               scan: int):
    """Tile (x, y) of each row's first ``scan`` rect slots [N, S], row-major
    from the rect's corner (x0, y0) with ``nx`` tiles a rect row (0 taken as
    1): sy = slot // nx through the reciprocal, exactly as the JAX module
    does (exact at these magnitudes; see its note)."""
    i32 = torch.int32
    slots = torch.arange(scan, dtype=i32, device=x0.device)   # [S]
    nx_safe = torch.clamp(nx, min=1)
    inv_nx = 1.0 / nx_safe.to(torch.float32)
    sy = torch.floor((slots[None, :].to(torch.float32) + 0.5)
                     * inv_nx[:, None]).to(i32)
    sx = slots[None, :] - sy * nx_safe[:, None]
    return x0[:, None] + sx, y0[:, None] + sy


def _qcap(opacity: torch.Tensor) -> torch.Tensor:
    """Per-row cap on ``_tile_qmin``: opac·exp(−qmin/2) ≥ αmin ⇔ qmin ≤
    2(log opac − log αmin), with the same (1−1e-3) margin and f32 constant
    as the JAX module."""
    with sync_point("binning_alpha_min"):         # a pageable host copy
        log_amin = torch.log(torch.tensor(ALPHA_MIN * (1.0 - 1e-3),
                                          dtype=torch.float32,
                                          device=opacity.device))
    return 2.0 * (torch.where(opacity > 0.0,
                              torch.log(torch.clamp(opacity, min=1e-30)),
                              torch.full_like(opacity, -math.inf))
                  - log_amin)


def bin_scan_plain(mean2d: torch.Tensor, conic: torch.Tensor,
                   radius: torch.Tensor, opacity: torch.Tensor,
                   valid: torch.Tensor, tiles_x: int, tiles_y: int,
                   scan: int):
    """Plain PyTorch version of ``bin_scan`` (same arguments and result):
    the [N, S] slot math, ``_tile_qmin`` and the keep test, then the
    per-row sort of the kept tiles."""
    dev = mean2d.device
    i32 = torch.int32
    with span("binning.scan"):
        x0, y0, x1, y1 = tile_rect(mean2d, radius, tiles_x, tiles_y)
        zero = torch.zeros_like(x0)
        nx = torch.where(valid, x1 - x0, zero)
        ny = torch.where(valid, y1 - y0, zero)
        coverage = nx * ny                                   # [N]
        covered = torch.clamp(coverage, max=scan)

        tile_x, tile_y = slot_tiles(x0, y0, nx, scan)       # [N, S]
        tile_id = tile_y * tiles_x + tile_x
        slots = torch.arange(scan, dtype=i32, device=dev)
        in_range = slots[None, :] < covered[:, None]
        qmin = _tile_qmin(mean2d, conic, tile_x, tile_y)
        keep = in_range & (qmin <= _qcap(opacity)[:, None])
        del qmin, tile_x, tile_y, in_range
        kept = torch.sum(keep, dim=1, dtype=i32)
    with span("binning.row_sort"):
        # Per-row compaction: surviving tiles first, ascending (a row's rect
        # tiles are distinct, so this order is unique).
        tile_id = torch.sort(torch.where(keep, tile_id,
                                         torch.full_like(tile_id,
                                                         TILE_SENTINEL)),
                             dim=1).values
    return kept, coverage, tile_id


def bin_scan(mean2d: torch.Tensor, conic: torch.Tensor, radius: torch.Tensor,
             opacity: torch.Tensor, valid: torch.Tensor, tiles_x: int,
             tiles_y: int, scan: int):
    """The binning's slot scan and per-row compaction.  For each of the N
    rows (``mean2d`` [N, 2], ``conic`` [N, 3], ``radius`` and ``opacity``
    [N] float32, ``valid`` [N] bool), the first ``scan`` tiles of its
    ``tile_rect`` in row-major slot order are tested against the alpha
    cull (``_tile_qmin`` ≤ ``_qcap``).  Returns int32 ``kept`` [N] (tiles
    kept), ``coverage`` [N] (tiles of the rect, 0 where not valid) and
    ``tile_id`` [N, scan]: each row's kept tile ids ascending, then
    ``TILE_SENTINEL``.  Launches ``csrc/bin_scan.cu`` on CUDA tensors (the
    cap stays this module's ``[N]`` expression); runs ``bin_scan_plain`` on
    CPU tensors."""
    dev = mean2d.device
    n = mean2d.shape[0]
    for name, x, dt, shape in (("mean2d", mean2d, torch.float32, (n, 2)),
                               ("conic", conic, torch.float32, (n, 3)),
                               ("radius", radius, torch.float32, (n,)),
                               ("opacity", opacity, torch.float32, (n,)),
                               ("valid", valid, torch.bool, (n,))):
        if x.dtype != dt or tuple(x.shape) != shape or \
                not x.is_contiguous() or x.device != dev:
            raise ValueError(f"bin_scan: {name} must be a contiguous {dt} "
                             f"tensor of shape {shape} on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if scan < 1:
        raise ValueError(f"bin_scan: scan must be positive, got {scan}")
    if not mean2d.is_cuda:
        if dev.type == "cpu":
            return bin_scan_plain(mean2d, conic, radius, opacity, valid,
                                  tiles_x, tiles_y, scan)
        raise RuntimeError(f"bin_scan: no kernel for {dev}")
    i32 = torch.int32
    with span("binning.scan"):
        qcap = _qcap(opacity)
        kept = torch.empty(n, dtype=i32, device=dev)
        coverage = torch.empty(n, dtype=i32, device=dev)
        tile_id = torch.empty((n, scan), dtype=i32, device=dev)
        native.launch("bin_scan", mean2d.data_ptr(), conic.data_ptr(),
                      radius.data_ptr(), valid.data_ptr(), qcap.data_ptr(),
                      n, tiles_x, tiles_y, scan, kept.data_ptr(),
                      coverage.data_ptr(), tile_id.data_ptr())
    return kept, coverage, tile_id


def _tail_bucket(kept, tile_id, inv_rank, n, start, budget, width, t_total):
    """Pair keys/ranks for compacted tile slots [start, start+width) of up to
    ``budget`` gaussians with kept > start, nearest (lowest depth rank)
    first.  Returns (keys, ranks, lost, sel_rows, granted): each selected
    row and the tail slots granted to it (for the emitted-pair count)."""
    flag = kept > start
    excess = torch.clamp(kept - start, 0, width)
    member = torch.where(flag, inv_rank, torch.full_like(inv_rank, n))
    member_sorted, sel_row = torch.sort(member, stable=True)
    member_b = member_sorted[:budget]
    valid = member_b < n
    sel_excess = torch.where(valid, excess[sel_row[:budget]],
                             torch.zeros_like(member_b))
    lost = torch.sum(excess, dtype=torch.int64) - torch.sum(
        sel_excess, dtype=torch.int64)
    sel_safe = torch.where(valid, sel_row[:budget],
                           torch.zeros_like(sel_row[:budget]))
    tiles = tile_id[:, start:start + width][sel_safe]        # [budget, width]
    live = (torch.arange(width, device=kept.device)[None, :]
            < sel_excess[:, None])
    keys = torch.where(live, tiles, torch.full_like(tiles, t_total)).reshape(-1)
    ranks = torch.where(valid, member_b, torch.zeros_like(member_b))
    ranks = ranks[:, None].expand(tiles.shape).reshape(-1)
    return keys, ranks, lost, sel_safe, sel_excess


def bin_gaussians(proj: Projected, height: int, width: int,
                  max_dup: int, tile_capacity: int,
                  dup_tails: tuple[tuple[int, int], ...] = DUP_TAILS,
                  vis_capacity: int | None = None,
                  key_mode: str | None = None,
                  exact_extra: int = 0,
                  with_seg_pos: bool = False,
                  exact_shards: int = 1,
                  dup_overscan: int = 0,
                  ) -> TileBins:
    """Same arguments and result as the JAX ``bin_gaussians``.

    ``key_mode`` is accepted for interface parity and validated; the int64
    packed key is unique, so every mode yields the same tables.
    ``exact_extra > 0`` enables exact (virtual-tile) mode: that many extra
    K-wide windows are budgeted, granted in tile order; pairs beyond the
    granted windows stay counted in ``tile_overflow``."""
    if key_mode not in KEY_MODES:
        raise ValueError(f"unknown key_mode {key_mode!r}")
    with torch.no_grad(), span("binning"):
        return _bin(proj, height, width, max_dup, tile_capacity, dup_tails,
                    vis_capacity, exact_extra, with_seg_pos, exact_shards,
                    dup_overscan)


def _bin(proj, height, width, max_dup, tile_capacity, dup_tails,
         vis_capacity, exact_extra, with_seg_pos, exact_shards,
         dup_overscan) -> TileBins:
    if with_seg_pos and vis_capacity is not None and \
            vis_capacity < proj.depth.shape[0]:
        raise NotImplementedError(
            "seg_pos (counts-based backward) with vis_capacity")
    proj = Projected(*(x.detach() for x in proj))
    dev = proj.depth.device
    n = proj.depth.shape[0]
    tiles_x, tiles_y = num_tiles(height, width)
    t_total = tiles_x * tiles_y
    i32 = torch.int32

    with span("binning.depth_sort"):
        # Stable: culled rows (depth +inf) tie and keep their row order.
        order = torch.sort(proj.depth, stable=True).indices
        inv_rank_n = torch.empty_like(order)
        inv_rank_n[order] = torch.arange(n, device=dev)

        if vis_capacity is not None and vis_capacity < n:
            # Visible compaction: keep the nearest V rows (depth-sorted rows
            # put the visible ones first); ranks become the identity in
            # V-space.
            v = vis_capacity
            sel = order[:v]
            mean2d, conic = proj.mean2d[sel], proj.conic[sel]
            radius, opacity = proj.radius[sel], proj.opacity[sel]
            n_valid = torch.sum(proj.valid, dtype=torch.int64)
            valid = torch.arange(v, device=dev) < n_valid
            vis_overflow = torch.clamp(n_valid - v, min=0)
            inv_rank = torch.arange(v, device=dev)
            rank_out = torch.clamp(inv_rank_n, max=v)
            order_out = sel
            m = v
        else:
            mean2d, conic = proj.mean2d, proj.conic
            radius, opacity = proj.radius, proj.opacity
            valid = proj.valid
            vis_overflow = torch.zeros((), dtype=torch.int64, device=dev)
            inv_rank = inv_rank_n
            rank_out, order_out = inv_rank_n, order
            m = n
        inv_rank = inv_rank.to(i32)

    scan = max_dup * (dup_overscan or DUP_OVERSCAN)
    n = m
    kept, coverage, tile_id = bin_scan(
        mean2d.contiguous(), conic.contiguous(), radius.contiguous(),
        opacity.contiguous(), valid.contiguous(), tiles_x, tiles_y, scan)
    with span("binning.tails"):
        live = (torch.arange(max_dup, dtype=i32, device=dev)[None, :]
                < torch.clamp(kept, max=max_dup)[:, None])
        keys = torch.where(live, tile_id[:, :max_dup],
                           torch.full_like(live, t_total,
                                           dtype=i32)).reshape(-1)
        ranks = inv_rank[:, None].expand(n, max_dup).reshape(-1)

        key_parts, rank_parts = [keys], [ranks]
        start = max_dup
        tail_lost = torch.zeros((), dtype=torch.int64, device=dev)
        emitted = torch.clamp(kept, max=max_dup)             # [N] per row
        for budget, width_t in dup_tails:
            width_t = min(width_t, scan - start)
            budget = min(budget, n)
            if width_t <= 0 or budget <= 0:
                continue
            tk, tr, lost, sel_rows, granted = _tail_bucket(
                kept, tile_id, inv_rank, n, start, budget, width_t, t_total)
            key_parts.append(tk)
            rank_parts.append(tr)
            emitted = emitted.index_add(0, sel_rows, granted.to(i32))
            tail_lost = tail_lost + lost
            start += width_t
        keys = torch.cat(key_parts)
        ranks = torch.cat(rank_parts)
        del tile_id, key_parts, rank_parts
        dup_overflow = (torch.sum(torch.clamp(kept - start, min=0),
                                  dtype=torch.int64)
                        + tail_lost
                        + torch.sum(torch.clamp(coverage - scan, min=0),
                                    dtype=torch.int64))

    with span("binning.key_sort"):
        rank_bits = max(1, (n - 1).bit_length())
        packed = (keys.to(torch.int64) << rank_bits) | ranks.to(torch.int64)
        del keys, ranks
        sorted_vals = torch.sort(packed).values
        del packed
        probes = torch.arange(t_total + 1, dtype=torch.int64,
                              device=dev) << rank_bits
        boundaries = torch.searchsorted(sorted_vals, probes).to(i32)
        starts = boundaries[:-1]
        counts = boundaries[1:] - starts

    if exact_extra > 0:
        with span("binning.windows"):
            exact, gather_starts, tile_overflow, granted = _windows(
                counts, starts, t_total, tile_capacity, exact_extra,
                exact_shards)
        count("binning.extra_windows", granted)
        gather_counts = exact["vcounts"]
    else:
        tile_overflow = torch.sum(torch.clamp(counts - tile_capacity, min=0),
                                  dtype=torch.int64)
        exact = dict()
        gather_starts, gather_counts = starts, counts

    with span("binning.k5"):
        # Masked slots carry the sentinel rank n (one past the last attr row).
        gather = slab_gather(sorted_vals, gather_starts, gather_counts,
                             tile_capacity, rank_bits, n)
        k = torch.arange(tile_capacity, dtype=i32, device=dev)
        mask = k[None, :] < torch.clamp(gather_counts,
                                        max=tile_capacity)[:, None]
        if with_seg_pos:
            # Per-RANK emitted-pair counts, then their exclusive prefix.
            er = torch.zeros_like(emitted)
            er[inv_rank.to(torch.int64)] = emitted
            exact["seg_pos"] = torch.cat([
                torch.zeros(1, dtype=i32, device=dev),
                torch.cumsum(er, 0, dtype=torch.int64).to(i32)])

    count("binning.rows", n)
    count("binning.slots", n * scan)
    count("binning.covered", torch.clamp(coverage, max=scan))
    count("binning.kept", kept)
    count("binning.pairs", counts)
    return TileBins(order=order_out, rank=rank_out, gather=gather, mask=mask,
                    counts=counts, dup_overflow=dup_overflow,
                    tile_overflow=tile_overflow,
                    tiles_x=tiles_x, tiles_y=tiles_y,
                    vis_overflow=vis_overflow, **exact)


def _windows(counts, starts, t_total, kcap, exact_extra, s_n):
    """Exact (virtual-tile) mode's windows: every real tile gets one K-wide
    window; tiles needing more draw extras from the budget in tile order.
    A tile's windows stay consecutive.  ``s_n`` (``exact_shards``) gives
    each shard of the (padded) tile range its own budget exact_extra / S.
    Returns (the ``TileBins`` fields of exact mode, each window's start in
    the sorted pairs, ``tile_overflow``, the extra windows granted a tile
    [S, L])."""
    dev, i32 = counts.device, torch.int32
    if exact_extra % s_n:
        raise ValueError("exact_extra must divide by exact_shards")
    t_pad_total = -(-t_total // s_n) * s_n
    pad_t = t_pad_total - t_total
    pad = torch.zeros((pad_t,), dtype=i32, device=dev)
    cnt_p = torch.cat([counts, pad])
    st_p = torch.cat([starts, pad])
    ln = t_pad_total // s_n
    e_s = exact_extra // s_n
    l_v = ln + e_s
    cnt2 = cnt_p.reshape(s_n, ln)
    nw_need = torch.clamp(-torch.div(-cnt2, kcap, rounding_mode="floor"),
                          min=1)
    extra_need = nw_need - 1
    ecum = torch.cumsum(extra_need, dim=1) - extra_need
    granted = torch.minimum(torch.clamp(e_s - ecum, min=0), extra_need)
    nw = 1 + granted
    cum = torch.cumsum(nw, dim=1)                            # [S, L]
    vv = torch.arange(l_v, dtype=cum.dtype, device=dev)
    tloc = torch.searchsorted(cum.contiguous(),
                              vv[None, :].expand(s_n, l_v).contiguous(),
                              right=True)                    # [S, L_v]
    used = tloc < ln
    tloc_safe = torch.clamp(tloc, max=ln - 1)

    def take(a):
        return torch.gather(a, 1, tloc_safe)

    zv = torch.zeros_like(tloc)
    wt2 = torch.where(used, vv[None, :] - (take(cum) - take(nw)), zv)
    starts_v = torch.where(used, take(st_p.reshape(s_n, ln)) + wt2 * kcap,
                           zv)
    vcounts = torch.where(
        used, torch.clamp(take(cnt2) - wt2 * kcap, 0, kcap), zv)
    shard_base = (torch.arange(s_n, device=dev) * ln)[:, None]
    t_of_v = torch.where(used, shard_base + tloc_safe,
                         torch.full_like(tloc, t_pad_total))
    last_v = ((torch.arange(s_n, device=dev) * l_v)[:, None]
              + cum - 1).reshape(-1)[:t_total]
    tile_overflow = torch.sum(torch.clamp(cnt2 - nw * kcap, min=0),
                              dtype=torch.int64)
    exact = dict(t_of_v=t_of_v.reshape(-1).to(i32),
                 wt=wt2.reshape(-1).to(i32),
                 last_v=last_v.to(i32),
                 vcounts=vcounts.reshape(-1).to(i32))
    return exact, starts_v.reshape(-1).to(i32), tile_overflow, granted
