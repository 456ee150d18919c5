"""Kernel-floor probes of K3 (the exact forward blend) on the card: D1-D3.

The counterpart of ``tools/kernel_floor_tpu.py``.  At the street production
config (one camera at 1920x1088 of the 1M-row street scene, exact binning
with K = 128, 9,216 budget windows, the street tails, overscan 32), it times
the real K3 against stubs that keep K3's window mechanics and swap its
blend math for less and less work (``csrc/blend_exact_stub.cu``):

- D1: channel-major attrs [T_v, 10, K], levels 2, 1, 0, -1, -2;
- D2: pair-major attrs [T_v, K, 10] (K3's layout), levels 2, 0, -1;
- D3: level 0 with one block walking 1, 2, 4 or 8 real tiles.

Per pixel each tile's stub output is, summed over its windows (B_v live
128-slot blocks of window v): L2 and L1 px * (the sum of every channel of
every slot of the live blocks), L0 128 * B_v * px, L-1 B_v, L-2 K / 128;
plus bg[0], in all eight rows.  The split it prints: the mechanics floor
(L0) as a share of the real kernel, what the loads add (L1 - L0), the cost
of one operation per slot-pixel ((L2 - L1) / 9) and the math share (real -
L2), from D1 as the TPU tool took it.

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
from ..ops.cuda_blend import N_CH, N_OUT, P, blend_exact, pack_gather_attrs
from ..ops.preprocess import project_gaussians
from ..profiling import PEAK_BYTES_S, PEAK_FLOP_S, event_ms, smi

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


def blend_exact_stub_plain(attrs: torch.Tensor, vcounts: torch.Tensor,
                           wt: torch.Tensor, last_v: torch.Tensor,
                           bg: torch.Tensor, tiles_x: int, level: int,
                           pair_major: bool):
    """Plain PyTorch version of the stub kernel (any ``tiles_per_block``
    gives the same values), in closed form (segment sums over each tile's
    windows, in float64): returns (out [T, 8, 256], terms [T, 256]),
    ``terms`` being each pixel's sum of |px * a| at levels 2 and 1 (zeros
    below)."""
    k = attrs.shape[1] if pair_major else attrs.shape[2]
    t = last_v.shape[0]
    dev = attrs.device
    first, last = _windows(vcounts, wt, last_v)
    blocks = window_blocks(vcounts, k, level)
    tiles = torch.arange(t, device=dev)
    px = ((tiles % tiles_x) * 16).to(torch.float64)[:, None] + (
        torch.arange(P, device=dev) % 16).to(torch.float64)[None, :]
    terms = torch.zeros((t, P), dtype=torch.float64, device=dev)
    if level >= 1:
        a = (attrs if pair_major else attrs.transpose(1, 2)).to(torch.float64)
        lanes = (torch.arange(k, device=dev)[None, :]
                 < blocks[:, None] * BLOCK)
        win = torch.where(lanes, a.sum(-1), 0.0).sum(-1)           # [T_v]
        win_abs = torch.where(lanes, a.abs().sum(-1), 0.0).sum(-1)
        acc = px * _per_tile(win, first, last)[:, None]
        terms = px.abs() * _per_tile(win_abs, first, last)[:, None]
    elif level == 0:
        acc = px * (BLOCK * _per_tile(blocks, first, last)).to(
            torch.float64)[:, None]
    else:
        acc = _per_tile(blocks, first, last).to(torch.float64)[:, None] \
            .expand(t, P)
    out = acc.to(torch.float32) + bg.reshape(-1)[0]
    return (out[:, None, :].expand(t, N_OUT, P).contiguous(),
            terms.to(torch.float32))


def blend_exact_stub(attrs: torch.Tensor, vcounts: torch.Tensor,
                     wt: torch.Tensor, last_v: torch.Tensor, bg: torch.Tensor,
                     tiles_x: int, level: int, pair_major: bool,
                     tiles_per_block: int = 1) -> torch.Tensor:
    """D1-D3: attrs f32 pair-major [T_v, K, 10] or channel-major [T_v, 10,
    K], vcounts, wt [T_v] and last_v [T] int32 of an exact ``TileBins``, bg
    [1, 3].  Returns [T, 8, 256].  Launches ``csrc/blend_exact_stub.cu`` on
    CUDA tensors; runs ``blend_exact_stub_plain`` on CPU tensors."""
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
            level not in (2, 1, 0, -1, -2) or tiles_per_block < 1:
        raise ValueError(f"blend_exact_stub: bad arguments (K {k}, bg "
                         f"{tuple(bg.shape)}, level {level}, tiles_per_block "
                         f"{tiles_per_block})")
    if attrs.device.type == "cpu":
        return blend_exact_stub_plain(attrs, vcounts, wt, last_v, bg,
                                      tiles_x, level, pair_major)[0]
    if not attrs.is_cuda:
        raise RuntimeError(f"blend_exact_stub: no kernel for {attrs.device}")
    t = last_v.shape[0]
    out = torch.empty((t, N_OUT, P), dtype=torch.float32, device=attrs.device)
    native.launch("blend_exact_stub", attrs.data_ptr(), vcounts.data_ptr(),
                  wt.data_ptr(), last_v.data_ptr(), bg.data_ptr(), t, k,
                  tiles_x, level, int(pair_major), tiles_per_block,
                  out.data_ptr())
    return out


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
               k: int, level: int):
    """(bound ms, bound_by, walked slots): the larger of the bytes (the
    walked slots' attrs at levels 2 and 1, the windows' metadata and the
    [T, 8, 256] output, each once, at PEAK_BYTES_S) and the f32 operations
    (FLOPS_PER_STEP per walked slot-pixel, plus the channel sums of level 1;
    one per block-pixel below level 0) at PEAK_FLOP_S."""
    first, last = _windows(vcounts, wt, last_v)
    blocks = _per_tile(window_blocks(vcounts, k, level), first, last)
    walked = int(blocks.sum()) * BLOCK
    t = last_v.shape[0]
    windows = int((last - first + 1).sum())
    bytes_ = (walked * N_CH * 4 if level >= 1 else 0) \
        + (2 * windows + t) * 4 + t * N_OUT * P * 4
    if level >= 0:
        flops = walked * P * FLOPS_PER_STEP[level] \
            + (walked * (N_CH - 1) if level == 1 else 0)
    else:
        flops = int(blocks.sum()) * P
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
    """(probe, level, pair_major, tiles_per_block) of every stub timed."""
    return ([("D1", lv, False, 1) for lv in LEVELS_D1]
            + [("D2", lv, True, 1) for lv in LEVELS_D2]
            + [("D3", 0, False, tpb) for tpb in TILES_PER_BLOCK_D3])


def measure(inputs, reps: int = 20, plain_reps: int = 3) -> dict:
    """Time the real K3 and every stub on ``inputs`` (``street_inputs``'
    tuple, on the card), hold each stub against its plain version, and
    derive the split.  Returns {"k3_ms", "stubs": [records], "split"};
    each record counts its own launches."""
    attrs, vcounts, wt, last_v, bg, tiles_x = inputs
    k = attrs.shape[1]
    layouts = {True: attrs, False: attrs.transpose(1, 2).contiguous()}
    with torch.no_grad():
        k3_ms = event_ms(lambda: blend_exact(attrs, vcounts, wt, last_v, bg,
                                             tiles_x), reps)
        records = []
        for probe, level, pm, tpb in variants():
            a = layouts[pm]
            args = (a, vcounts, wt, last_v, bg, tiles_x, level, pm)
            before = native.LAUNCHES["blend_exact_stub"]
            ms = event_ms(lambda: blend_exact_stub(*args, tpb), reps)
            got = blend_exact_stub(*args, tpb)
            launches = native.LAUNCHES["blend_exact_stub"] - before
            plain_ms = event_ms(lambda: blend_exact_stub_plain(*args),
                                plain_reps)
            want, terms = blend_exact_stub_plain(*args)
            bound_ms, bound_by, walked = stub_bound(vcounts, wt, last_v, k,
                                                    level)
            records.append({
                "probe": probe, "level": level,
                "layout": "pair-major" if pm else "channel-major",
                "tiles_per_block": tpb, "launches": launches, "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "walked_slots": walked,
                "max_abs_err": stub_error(got, want, terms, level),
                "max_err_over_sum_terms": float(
                    ((got - want).abs() / terms[:, None, :].clamp_min(1e-30))
                    .max()) if level >= 1 else 0.0})
    d1 = {r["level"]: r["ms"] for r in records if r["probe"] == "D1"}
    split = {"k3_ms": k3_ms, "mechanics_floor_ms": d1[0],
             "mechanics_share_of_k3": d1[0] / k3_ms,
             "loads_add_ms": d1[1] - d1[0],
             "per_slot_pixel_op_ms": (d1[2] - d1[1]) / 9,
             "math_ms": k3_ms - d1[2], "layout": "D1 channel-major"}
    return {"k3_ms": k3_ms, "stubs": records, "split": split}


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
    print(json.dumps({"probe": "K3", "ms": res["k3_ms"], "card": card}))
    for r in res["stubs"]:
        print(json.dumps({**r, "card": card}))
    print(json.dumps({"split": res["split"], "card": card}))
    return res


if __name__ == "__main__":
    main()
