"""Kernel-floor probes of K3 (the exact forward blend) on the card: D1-D3.

The counterpart of ``tools/kernel_floor_tpu.py``.  At the street production
config (one camera at 1920x1088 of the 1M-row street scene, exact binning
with K = 128, 9,216 budget windows, the street tails, overscan 32), it times
the real K3 against stubs that run K3's own kernels (plan, tables, tile
order, the window split at ``EXACT_GROUP``, cp.async staging, the per-slot
threshold) with its blend math swapped for less and less work
(``csrc/blend_exact_stub.cu``):

- D1: channel-major attrs [T_v, 10, K] (staged as K1 stages), levels 2, 1,
  0, -1, -2;
- D2: pair-major attrs [T_v, K, 10] (K3's layout and staging), levels 2, 0,
  -1;
- D3: D1's level 0 with one pass-1 block walking 1, 2, 4 or 8 rows of the
  block table (a row is a tile walked whole or one group of a split tile);
- D1 and D2 at level 2 once more without the split (as K3's
  ``no_split_ms``).

Per pixel each tile's stub output is, summed over its windows (B_v live
128-slot blocks of window v): L2 and L1 px * (the sum of every channel of
every slot of the live blocks), L0 128 * B_v * px, L-1 B_v, L-2 K / 128;
plus bg[0], in all eight rows.  The split it prints names the probe and
layout each field reads: the mechanics floor (D2 L0, K3's staging) as a
share of the real kernel, what the loads add (D1 L1 - L0), the cost of one
operation per slot-pixel (D1 (L2 - L1) / 9), the same floor from D1, what
K1's staging costs against K3's (D1 L2 - D2 L2), and K3 and D1, D2 L2 at
no split.  It gives no math share (real - L2): L2 does ten operations on
every walked slot-pixel, where K3 skips most steps after the power, so L2
is no lower bound of K3's walk.

Run on the card from the repository root (one JSON line per measurement,
each with the card's name and power limit)::

    python -m street_sparse_3dgs_tpu_torch.tools.kernel_floor
"""

from __future__ import annotations

import argparse
import json

import torch

from .. import native
from ..data.toy import make_street_scene
from ..device import resolve_device
from ..ops.binning import bin_gaussians
from ..ops.cuda_blend import (EXACT_GROUP, N_CH, N_OUT, P, blend_exact,
                              blend_exact_launch, exact_scratch,
                              exact_split_plan, pack_gather_attrs)
from ..ops.preprocess import project_gaussians
from ..profiling import PEAK_BYTES_S, PEAK_FLOP_S, device_ms, event_ms, smi

H, W = 1088, 1920
KCAP = 128
EXTRA = 9216
TAILS = ((262144, 6), (16384, 24), (4096, 224))
BLOCK = 128                        # the TPU stubs' lane block
LEVELS_D1 = (2, 1, 0, -1, -2)
LEVELS_D2 = (2, 0, -1)
TILES_PER_BLOCK_D3 = (1, 2, 4, 8)
# L2 and L1 against the plain version: the kernel sums in f32 in another
# order, so each pixel may differ by this much of the sum of |terms|.
SUM_RTOL = 2e-6
# f32 operations of one (walked slot, pixel) step per level.
FLOPS_PER_STEP = {2: 20, 1: 2, 0: 1}


def _windows(vcounts: torch.Tensor, wt: torch.Tensor, last_v: torch.Tensor):
    """(first, last) window of each real tile, int64."""
    last = last_v.to(torch.int64)
    return last - wt.to(torch.int64)[last], last


def _per_tile(x: torch.Tensor, first: torch.Tensor,
              last: torch.Tensor) -> torch.Tensor:
    """Sum of the per-window values ``x`` over each tile's windows (a
    segment sum, not a difference of prefix sums: one window with a huge
    sum must not cost the other tiles their precision)."""
    nw = last - first + 1
    tile = torch.repeat_interleave(torch.arange(nw.shape[0],
                                                device=nw.device), nw)
    start = torch.cumsum(nw, 0) - nw
    v = first[tile] + torch.arange(tile.shape[0], device=nw.device) \
        - start[tile]
    return x.new_zeros(nw.shape[0]).index_add_(0, tile, x[v])


def window_blocks(vcounts: torch.Tensor, k: int, level: int) -> torch.Tensor:
    """[T_v] int64 128-slot blocks each window walks at ``level``: its live
    blocks, or every block of the window at level -2."""
    if level <= -2:
        return torch.full_like(vcounts, k // BLOCK, dtype=torch.int64)
    live = torch.clamp(vcounts.to(torch.int64), max=k)
    return torch.div(live + BLOCK - 1, BLOCK, rounding_mode="floor")


def _window_sums(attrs: torch.Tensor, vcounts: torch.Tensor, level: int,
                 pair_major: bool):
    """(blocks [T_v] int64, win, win_abs [T_v] float64): the 128-slot
    blocks each window walks at ``level`` and, at levels 2 and 1, the sum
    of every channel of the slots of those blocks and of their |values|
    (None below)."""
    k = attrs.shape[1] if pair_major else attrs.shape[2]
    blocks = window_blocks(vcounts, k, level)
    if level < 1:
        return blocks, None, None
    a = (attrs if pair_major else attrs.transpose(1, 2)).to(torch.float64)
    lanes = torch.arange(k, device=attrs.device)[None, :] \
        < blocks[:, None] * BLOCK
    win = torch.where(lanes, a.sum(-1), 0.0).sum(-1)
    win_abs = torch.where(lanes, a.abs().sum(-1), 0.0).sum(-1)
    return blocks, win, win_abs


def _tile_px(tiles: torch.Tensor, tiles_x: int) -> torch.Tensor:
    """[C, 256] float64 pixel x of each tile's pixels."""
    return ((tiles % tiles_x) * 16).to(torch.float64)[:, None] + (
        torch.arange(P, device=tiles.device) % 16).to(torch.float64)[None, :]


def _run_values(sums, first: torch.Tensor, last: torch.Tensor,
                px: torch.Tensor, level: int):
    """Each run of windows [first, last]'s stub sum per pixel (float64 [C,
    256]) and, at levels 2 and 1, its sum of |terms| (zeros below)."""
    blocks, win, win_abs = sums
    if level >= 1:
        return (px * _per_tile(win, first, last)[:, None],
                px.abs() * _per_tile(win_abs, first, last)[:, None])
    if level == 0:
        acc = px * (BLOCK * _per_tile(blocks, first, last)).to(
            torch.float64)[:, None]
    else:
        acc = _per_tile(blocks, first, last).to(torch.float64)[:, None] \
            .expand_as(px)
    return acc, torch.zeros_like(px)


def blend_exact_stub_plain(attrs: torch.Tensor, vcounts: torch.Tensor,
                           wt: torch.Tensor, last_v: torch.Tensor,
                           bg: torch.Tensor, tiles_x: int, level: int,
                           pair_major: bool):
    """Plain PyTorch version of the stub kernel (any ``tiles_per_block``
    and ``group`` give the same values), in closed form (segment sums over
    each tile's windows, in float64): returns (out [T, 8, 256], terms [T,
    256]), ``terms`` being each pixel's sum of |px * a| at levels 2 and 1
    (zeros below)."""
    t = last_v.shape[0]
    first, last = _windows(vcounts, wt, last_v)
    px = _tile_px(torch.arange(t, device=attrs.device), tiles_x)
    acc, terms = _run_values(_window_sums(attrs, vcounts, level, pair_major),
                             first, last, px, level)
    out = acc.to(torch.float32) + bg.reshape(-1)[0]
    return (out[:, None, :].expand(t, N_OUT, P).contiguous(),
            terms.to(torch.float32))


def blend_exact_stub_split_plain(attrs: torch.Tensor, vcounts: torch.Tensor,
                                 wt: torch.Tensor, last_v: torch.Tensor,
                                 bg: torch.Tensor, tiles_x: int, level: int,
                                 pair_major: bool,
                                 group: int = EXACT_GROUP) -> torch.Tensor:
    """Plain twin of the stub kernel's split (``csrc/blend_exact_stub.cu``
    on K3's kernels), on the block tables of ``exact_split_plan``: each
    block's sum over its windows (float64, then float32 as the block's
    partial row); a tile walked whole writes its sum + bg[0], a split tile
    the float32 sum of its groups' partials in group order + bg[0] (the
    drops that pass 2 reads change no value).  Returns [T, 8, 256]."""
    t = last_v.shape[0]
    dev = attrs.device
    table, _, combine, _ = exact_split_plan(vcounts, wt, last_v, group)
    table = table[table[:, 0] >= 0].to(torch.int64)
    tile, v0, nw, q = table.unbind(1)
    acc, _ = _run_values(_window_sums(attrs, vcounts, level, pair_major),
                         v0, v0 + nw - 1, _tile_px(tile, tiles_x), level)
    rows = acc.to(torch.float32)
    bg0 = bg.reshape(-1)[0]
    out = torch.empty((t, P), dtype=torch.float32, device=dev)
    whole = q < 0
    out[tile[whole]] = rows[whole] + bg0
    combine = combine[combine[:, 0] >= 0].to(torch.int64)
    if combine.shape[0]:
        part = torch.zeros((int(q.max()) + 1, P), dtype=torch.float32,
                           device=dev)
        part[q[~whole]] = rows[~whole]
        t_c, q0, ng = combine.unbind(1)
        total = torch.zeros((t_c.shape[0], P), dtype=torch.float32,
                            device=dev)
        for h in range(int(ng.max())):
            take = (h < ng)[:, None]
            total = torch.where(take, total + part[torch.clamp(
                q0 + h, max=part.shape[0] - 1)], total)
        out[t_c] = total + bg0
    return out[:, None, :].expand(t, N_OUT, P).contiguous()


def blend_exact_stub(attrs: torch.Tensor, vcounts: torch.Tensor,
                     wt: torch.Tensor, last_v: torch.Tensor, bg: torch.Tensor,
                     tiles_x: int, level: int, pair_major: bool,
                     tiles_per_block: int = 1,
                     group: int = EXACT_GROUP) -> torch.Tensor:
    """D1-D3: attrs f32 pair-major [T_v, K, 10] or channel-major [T_v, 10,
    K], vcounts, wt [T_v] and last_v [T] int32 of an exact ``TileBins``, bg
    [1, 3]; tiles of more than ``group`` windows split as K3 splits them
    (0: no split).  Returns [T, 8, 256].  Launches
    ``csrc/blend_exact_stub.cu`` on CUDA tensors (with K3's scratch,
    ``exact_scratch``); runs ``blend_exact_stub_plain`` on CPU tensors."""
    nv = vcounts.shape[0]
    want = (nv, attrs.shape[1], N_CH) if pair_major \
        else (nv, N_CH, attrs.shape[2])
    if attrs.dtype != torch.float32 or tuple(attrs.shape) != want or \
            not attrs.is_contiguous():
        raise ValueError(f"blend_exact_stub: attrs must be a contiguous f32 "
                         f"{'pair' if pair_major else 'channel'}-major "
                         f"tensor {want}, got {attrs.dtype} "
                         f"{tuple(attrs.shape)}")
    for name, x in (("vcounts", vcounts), ("wt", wt), ("last_v", last_v)):
        if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous() \
                or x.device != attrs.device:
            raise ValueError(f"blend_exact_stub: {name} must be a contiguous "
                             f"1-d int32 tensor on {attrs.device}")
    k = want[1] if pair_major else want[2]
    if wt.shape[0] != nv or tuple(bg.shape) != (1, 3) or k % BLOCK or \
            level not in (2, 1, 0, -1, -2) or tiles_per_block < 1 or \
            group < 0:
        raise ValueError(f"blend_exact_stub: bad arguments (K {k}, bg "
                         f"{tuple(bg.shape)}, level {level}, tiles_per_block "
                         f"{tiles_per_block}, group {group})")
    if attrs.device.type == "cpu":
        return blend_exact_stub_plain(attrs, vcounts, wt, last_v, bg,
                                      tiles_x, level, pair_major)[0]
    if not attrs.is_cuda:
        raise RuntimeError(f"blend_exact_stub: no kernel for {attrs.device}")
    t = last_v.shape[0]
    sc = exact_scratch(t, nv, t, group, attrs.device)
    native.launch("blend_exact_stub", attrs.data_ptr(), vcounts.data_ptr(),
                  wt.data_ptr(), last_v.data_ptr(), bg.data_ptr(), t, k,
                  tiles_x, level, int(pair_major), tiles_per_block, group,
                  *sc.pointers(), sc.out.data_ptr())
    return sc.out


def stub_error(got: torch.Tensor, want: torch.Tensor, terms: torch.Tensor,
               level: int) -> float:
    """Largest |got - want|; raises unless levels 0, -1, -2 are equal and
    levels 2 and 1 within SUM_RTOL of each pixel's sum of |terms|."""
    err = (got - want).abs()
    if level >= 1:
        over = err > SUM_RTOL * terms[:, None, :]
        if bool(over.any()):
            rel = err / terms[:, None, :].clamp_min(1e-30)
            raise AssertionError(
                f"stub level {level}: {int(over.sum())} values off by more "
                f"than {SUM_RTOL} x sum|terms| (max err {float(err.max())}, "
                f"max err / sum|terms| {float(rel.max())} at tile "
                f"{int(rel.amax(dim=(1, 2)).argmax())})")
    elif not torch.equal(got, want):
        raise AssertionError(f"stub level {level}: not equal to the plain "
                             f"version (max err {float(err.max())})")
    return float(err.max())


def stub_bound(vcounts: torch.Tensor, wt: torch.Tensor, last_v: torch.Tensor,
               k: int, level: int, group: int = EXACT_GROUP):
    """(bound ms, bound_by, walked slots): the larger of the bytes (the
    live blocks' attrs at levels 2 and 1, the windows' metadata and the
    [T, 8, 256] output, each once, at PEAK_BYTES_S) and the f32 operations
    (FLOPS_PER_STEP per walked slot-pixel, plus the channel sums of level 1;
    one per block-pixel below level 0) at PEAK_FLOP_S.  The walked slots
    are those of the split's walk at ``group``: phase A walks the middle
    groups of each split tile a second time."""
    first, last = _windows(vcounts, wt, last_v)
    per_window = window_blocks(vcounts, k, level)
    once = int(_per_tile(per_window, first, last).sum())
    table = exact_split_plan(vcounts, wt, last_v, group)[0].to(torch.int64)
    tile, v0, nw, q = table[table[:, 0] >= 0].unbind(1)
    v_last = last_v.to(torch.int64)[tile]
    g_first = v_last - wt.to(torch.int64)[v_last]
    mid = (q >= 0) & (v0 > g_first) & (v0 + nw <= v_last)
    again = int(_per_tile(per_window, v0[mid], v0[mid] + nw[mid] - 1).sum()) \
        if bool(mid.any()) else 0
    blocks = once + again
    walked = blocks * BLOCK
    t = last_v.shape[0]
    windows = int((last - first + 1).sum())
    bytes_ = (once * BLOCK * N_CH * 4 if level >= 1 else 0) \
        + (2 * windows + t) * 4 + t * N_OUT * P * 4
    if level >= 0:
        flops = walked * P * FLOPS_PER_STEP[level] \
            + (walked * (N_CH - 1) if level == 1 else 0)
    else:
        flops = blocks * P
    t_bytes, t_ops = bytes_ / PEAK_BYTES_S, flops / PEAK_FLOP_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", walked)


def street_inputs(device: str | torch.device = "cuda", n: int = 1_000_000):
    """The K3 inputs of the street view the TPU tool times: (attrs
    pair-major [T_v, K, 10], vcounts, wt, last_v, bg [1, 3], tiles_x)."""
    dev = resolve_device(device)
    scene = make_street_scene(seed=0, n=n, n_cameras=1, width=W, height=H,
                              device=dev)
    with torch.no_grad():
        proj = project_gaussians(scene.means3d, scene.scales, scene.quats,
                                 scene.opacities, scene.sh_coeffs,
                                 scene.cameras[0], 3)
        bins = bin_gaussians(proj, H, W, 2, KCAP, dup_tails=TAILS,
                             dup_overscan=32, exact_extra=EXTRA,
                             with_seg_pos=True)
        attrs = pack_gather_attrs(
            bins.gather, proj.mean2d, proj.conic, proj.color, proj.opacity,
            proj.inv_depth, order=bins.order, rank=bins.rank,
            seg_pos=bins.seg_pos, pair_major=True)
    return (attrs.contiguous(), bins.vcounts, bins.wt, bins.last_v,
            torch.zeros((1, 3), device=dev), bins.tiles_x)


def variants():
    """(probe, level, pair_major, tiles_per_block, group) of every stub
    timed; the first of each probe is its headline."""
    g = EXACT_GROUP
    return ([("D1", lv, False, 1, g) for lv in LEVELS_D1]
            + [("D1", 2, False, 1, 0)]
            + [("D2", lv, True, 1, g) for lv in LEVELS_D2]
            + [("D2", 2, True, 1, 0)]
            + [("D3", 0, False, tpb, g) for tpb in TILES_PER_BLOCK_D3])


def split_of(k3_ms: float, k3_no_split_ms: float, records) -> dict:
    """The split of K3's time from the stub records, each field named for
    the probe and layout it reads; ``out_of_range`` lists the fields that
    came out negative or above K3's time."""
    ms = {(r["probe"], r["level"], r["tiles_per_block"], r["group"]):
          r["ms"] for r in records}

    def d(probe, level, group=EXACT_GROUP):
        return ms[(probe, level, 1, group)]

    no_split = {"k3_ms": k3_no_split_ms,
                "d1_channel_major_l2_ms": d("D1", 2, 0),
                "d2_pair_major_l2_ms": d("D2", 2, 0)}
    split = {
        "k3_ms": k3_ms, "group": EXACT_GROUP,
        "mechanics_floor_ms_d2_pair_major": d("D2", 0),
        "mechanics_share_of_k3_d2_pair_major": d("D2", 0) / k3_ms,
        "loads_add_ms_d1_channel_major": d("D1", 1) - d("D1", 0),
        "per_slot_pixel_op_ms_d1_channel_major": (d("D1", 2)
                                                  - d("D1", 1)) / 9,
        "mechanics_floor_ms_d1_channel_major": d("D1", 0),
        "d1_channel_minus_d2_pair_major_l2_ms": d("D1", 2) - d("D2", 2),
        "no_split": no_split}
    values = {**{k: v for k, v in split.items() if "_ms" in k},
              **{f"no_split.{k}": v for k, v in no_split.items()}}
    del values["d1_channel_minus_d2_pair_major_l2_ms"]   # either sign
    split["out_of_range"] = sorted(
        k for k, v in values.items()
        if v < 0 or v > (k3_no_split_ms if k.startswith("no_split")
                         else k3_ms))
    return split


def measure(inputs, reps: int = 20, plain_reps: int = 3) -> dict:
    """Time the real K3 (with and without its split) and every stub on
    ``inputs`` (``street_inputs``' tuple, on the card): ``ms`` device time
    (``profiling.device_ms``), ``wall_ms`` events around back-to-back
    calls.  Hold each stub against its plain version and derive the split.
    Returns {"k3_ms", "k3_wall_ms", "k3_no_split_ms", "stubs": [records],
    "split"}; each record counts its own launches."""
    attrs, vcounts, wt, last_v, bg, tiles_x = inputs
    k = attrs.shape[1]
    layouts = {True: attrs, False: attrs.transpose(1, 2).contiguous()}
    with torch.no_grad():
        def k3():
            return blend_exact(attrs, vcounts, wt, last_v, bg, tiles_x)
        k3_ms, k3_wall_ms = device_ms(k3, reps), event_ms(k3, reps)
        k3_no_split_ms = device_ms(lambda: blend_exact_launch(
            attrs, vcounts, wt, last_v, bg, tiles_x, 0, None, 0), reps)
        records = []
        for probe, level, pm, tpb, group in variants():
            a = layouts[pm]
            args = (a, vcounts, wt, last_v, bg, tiles_x, level, pm)
            before = native.LAUNCHES["blend_exact_stub"]

            def stub():
                return blend_exact_stub(*args, tpb, group)
            ms, wall_ms = device_ms(stub, reps), event_ms(stub, reps)
            got = stub()
            launches = native.LAUNCHES["blend_exact_stub"] - before
            plain_ms = event_ms(lambda: blend_exact_stub_plain(*args),
                                plain_reps)
            want, terms = blend_exact_stub_plain(*args)
            bound_ms, bound_by, walked = stub_bound(vcounts, wt, last_v, k,
                                                    level, group)
            records.append({
                "probe": probe, "level": level,
                "layout": "pair-major" if pm else "channel-major",
                "tiles_per_block": tpb, "group": group,
                "launches": launches, "ms": ms, "wall_ms": wall_ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "walked_slots": walked,
                "max_abs_err": stub_error(got, want, terms, level),
                "max_err_over_sum_terms": float(
                    ((got - want).abs() / terms[:, None, :].clamp_min(1e-30))
                    .max()) if level >= 1 else 0.0})
    return {"k3_ms": k3_ms, "k3_wall_ms": k3_wall_ms,
            "k3_no_split_ms": k3_no_split_ms, "stubs": records,
            "split": split_of(k3_ms, k3_no_split_ms, records)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("kernel_floor times the CUDA kernels: run it on a "
                         "card (--device cuda)")
    card = smi("name,power.limit")
    res = measure(street_inputs(dev), args.reps)
    print(json.dumps({"probe": "K3", "ms": res["k3_ms"],
                      "wall_ms": res["k3_wall_ms"],
                      "no_split_ms": res["k3_no_split_ms"], "card": card}))
    for r in res["stubs"]:
        print(json.dumps({**r, "card": card}))
    print(json.dumps({"split": res["split"], "card": card}))
    return res


if __name__ == "__main__":
    main()
