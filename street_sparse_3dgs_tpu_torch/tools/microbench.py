"""Primitive microbenchmarks of the street-scale raster step on the card,
the port's counterpart of ``tools/microbench_tpu.py``.

Times, on their own, the candidate building blocks behind the binning and
the backward's slot reduction: pair sorts at emission sizes, the backward
reduction candidates on the street slot grid (P = 8160 x 384 slots plus
1,000,001 queries), gather and transpose layouts ([M, 10] against
[10, M]), the [8160, 768] sort along dim 1 and the attribute gathers
(random against tile-sorted), plus the primitives the port's binning runs
at street sizes (``ops/binning.py``: the stable depth sort, the per-row
tile sort, the packed-key sort and the tile boundaries' ``searchsorted``)
for the production exact config and the viewer's padded one.

Each workload has a reference candidate; every other candidate is held
against it on the same input before anything is timed (sorts must give the
same sorted keys and payloads, reductions equal ``index_add_`` to 1e-5 of
the largest row, cumsums the float64 one to 1e-5 of the running sum of
|x|).  A candidate's time is ``profiling.device_ms`` over ``ITERS`` calls
(2 where one call takes over 100 ms) on the card, the host clock's mean on
the CPU.  No hand-written kernel runs
here.  Prints one line per candidate and the dict of times at the end::

    python -m street_sparse_3dgs_tpu_torch.tools.microbench [--device cpu]
        [--scale 0.001]

``--scale`` shrinks every size (the CPU tests run it tiny).  ``main``
returns {"ms": {name: ms}, "checks": {name: error}}.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops.cuda_blend import slot_grads_to_rows

ITERS = 8
SLOW_ITERS, SLOW_MS = 2, 100.0    # fewer calls for a candidate this slow
TILES = 8160                 # 1920x1088 in 16-pixel tiles
K = 384
QUERIES = 1_000_001
ROWS = 1_000_000
PAIR_SORTS = (4_000_000, 8_000_000, 16_000_000)
# Binning at the street scale: 1M rows; the exact production config
# (max_dup 2, overscan 32, the two-level tail ladder) and the viewer's
# padded RasterConfig() (max_dup 64, overscan 4, the default tails).
BIN_CONFIGS = {"street_exact": (2, 32, ((262144, 6), (16384, 24),
                                        (4096, 224))),
               "viewer_padded": (64, 4, ((8192, 32), (512, 96)))}
REDUCE_RTOL = 1e-5
CUMSUM_RTOL = 1e-5


class Bench:
    """Runs the workloads: holds each candidate against its reference, then
    times it."""

    def __init__(self, dev: torch.device, scale: float, seed: int = 0):
        self.dev, self.scale = dev, scale
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.ms: dict[str, float] = {}
        self.checks: dict[str, float] = {}

    def size(self, n: int) -> int:
        return max(16, int(n * self.scale))

    def randint(self, lo: int, hi: int, shape, dtype=torch.int32):
        return torch.randint(lo, hi, tuple(np.atleast_1d(shape)),
                             generator=self.gen, device=self.dev, dtype=dtype)

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.dev)

    def rand(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, device=self.dev)

    def time(self, fn, first_ms: float) -> float:
        """Mean ms of ``fn`` over ``ITERS`` calls (``SLOW_ITERS`` where its
        first call took over ``SLOW_MS``)."""
        reps = ITERS if first_ms < SLOW_MS else SLOW_ITERS
        if self.dev.type == "cuda":
            from ..profiling import device_ms
            return device_ms(fn, reps)
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    def call(self, fn) -> tuple:
        """(result, host ms of the synchronised call)."""
        t0 = time.perf_counter()
        out = fn()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return out, (time.perf_counter() - t0) * 1e3

    def workload(self, cands: dict, agree) -> None:
        """``cands`` maps names to functions, the reference first;
        ``agree(ref_out, out)`` returns an error and raises on a
        disagreement."""
        ref = None
        for name, fn in cands.items():
            out, first_ms = self.call(fn)
            if ref is None:
                ref = out
                self.checks[name] = 0.0
            else:
                self.checks[name] = float(agree(ref, out, name))
            del out
            ms = self.time(fn, first_ms)
            self.ms[name] = ms
            print(f"{ms:9.3f} ms  {name}", flush=True)
        del ref


def equal(ref, out, name) -> float:
    refs = ref if isinstance(ref, tuple) else (ref,)
    outs = out if isinstance(out, tuple) else (out,)
    for a, b in zip(refs, outs, strict=True):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: differs from its reference")
    return 0.0


def close_rows(ref, out, name) -> float:
    err = float((ref - out).abs().max()) / max(float(ref.abs().max()), 1e-30)
    if err > REDUCE_RTOL:
        raise AssertionError(f"{name}: {err:.3e} of max|ref| off index_add_")
    return err


def tag(m: int) -> str:
    return f"{m / 1e6:g}M" if m >= 100_000 else str(m)


def pair_sorts(b: Bench) -> None:
    """Pair sorts at emission sizes: 13-bit tile keys and 18-bit ranks,
    sorted by (key, rank); JAX's ``lax.sort`` operand counts become a
    packed key or stable sorts, payloads an ``index_select`` or a
    ``gather``."""
    for m0 in PAIR_SORTS:
        m = b.size(m0)
        keys = b.randint(0, TILES + 1, m)
        ranks = b.randint(0, 1 << 18, m)
        packed = (keys << 18) | ranks
        mask = (1 << 18) - 1

        def sort1op():
            v = torch.sort(packed).values
            return v >> 18, v & mask

        def packed64():
            v = torch.sort((keys.to(torch.int64) << 32) | ranks).values
            return (v >> 32).to(torch.int32), (v & 0xFFFFFFFF).to(torch.int32)

        def two_stable():
            i1 = torch.sort(ranks, stable=True).indices
            i2 = torch.sort(keys[i1], stable=True).indices
            i = i1[i2]
            return keys[i], ranks[i]

        def payload1_index_select():
            v, i = torch.sort(packed, stable=True)
            return v >> 18, ranks.index_select(0, i)

        def payload1_argsort_gather():
            i = torch.argsort(packed, stable=True)
            return torch.gather(packed, 0, i) >> 18, torch.gather(ranks, 0, i)

        two = torch.stack([ranks, ranks], dim=1)

        def payload2_index_select():
            v, i = torch.sort(packed, stable=True)
            p = two.index_select(0, i)
            return v >> 18, p[:, 1]

        s = tag(m)
        b.workload({f"sort1op_{s}": sort1op,
                    f"sort2key_packed64_{s}": packed64,
                    f"sort2key_two_stable_{s}": two_stable,
                    f"sort_payload1_index_select_{s}": payload1_index_select,
                    f"sort_payload1_argsort_gather_{s}":
                        payload1_argsort_gather,
                    f"sort_payload2_index_select_{s}": payload2_index_select},
                   equal)
        del keys, ranks, packed, two


def backward_reduce(b: Bench) -> None:
    """The backward's slot grid: sorts with payloads, gathers, layouts,
    cumsums, the scatter-add against the port's sort + segment_reduce."""
    p, nq = b.size(TILES * K), b.size(QUERIES)
    m = p + nq
    n_rows = b.size(ROWS)
    ids = b.randint(0, n_rows, p)
    keys_m = torch.cat([ids * 2 + 1, torch.arange(
        nq, dtype=torch.int32, device=b.dev) * 2])
    rows = b.normal((m, 10))                                     # [M, 10]
    cm = rows.T.contiguous()                                     # [10, M]
    s = tag(m)

    def sort_rows(keys, r):
        def f():
            v, i = torch.sort(keys, stable=True)
            return v, r.index_select(0, i)
        return f

    def argsort_gather_cm(keys, c):
        def f():
            i = torch.argsort(keys, stable=True)
            return (torch.gather(keys, 0, i),
                    torch.gather(c, 1, i[None].expand(c.shape[0], -1)).T)
        return f

    b.workload({f"bwd_sort_rows10_index_select_{s}": sort_rows(keys_m, rows),
                f"bwd_argsort_gather10_cm_{s}":
                    argsort_gather_cm(keys_m, cm)}, equal)
    iota = torch.arange(m, dtype=torch.int32, device=b.dev)
    b.workload({f"bwd_plan_sort_indices_{s}":
                    lambda: torch.sort(keys_m, stable=True).indices,
                f"bwd_plan_sort_iota_payload_{s}":
                    lambda: iota.index_select(0, torch.sort(
                        keys_m, stable=True).indices).to(torch.int64)},
               equal)

    plan = torch.randperm(m, generator=b.gen, device=b.dev)
    b.workload({f"bwd_rowgather_{s}x10": lambda: rows.index_select(0, plan),
                f"bwd_colgather_10x{s}_cm":
                    lambda: cm.index_select(1, plan).T}, equal)
    b.workload({f"transpose_cm_to_rm_{s}": lambda: cm.T.contiguous(),
                f"transpose_rm_to_cm_{s}":
                    lambda: rows.T.contiguous().T}, equal)

    ref64 = torch.cumsum(rows.double(), dim=0)
    run_abs = torch.cumsum(rows.double().abs(), dim=0)

    def cumsum_err(_, out, name):
        err = float(((out.double() - ref64).abs() / run_abs.clamp(
            min=1e-30)).max())
        if err > CUMSUM_RTOL:
            raise AssertionError(f"{name}: {err:.3e} of the running sum of "
                                 "|x| off the float64 cumsum")
        return err

    b.workload({f"cumsum_f64_{s}x10":
                    lambda: torch.cumsum(rows.double(), dim=0),
                f"cumsum_rm_{s}x10": lambda: torch.cumsum(rows, dim=0),
                f"cumsum_cm_10x{s}": lambda: torch.cumsum(cm, dim=1).T},
               cumsum_err)
    del ref64, run_abs

    pos = torch.sort(b.randint(0, m, nq, torch.int64)).values
    b.workload({f"posgather_{tag(nq)}x10_from_{s}x10":
                    lambda: rows.index_select(0, pos),
                f"posgather_cm_10x{tag(nq)}_from_10x{s}":
                    lambda: cm.index_select(1, pos).T}, equal)

    seg = torch.sort(b.randint(0, n_rows, p, torch.int64)).values
    vals = rows[:p]
    seg_pos = torch.searchsorted(seg, torch.arange(n_rows + 1,
                                                   device=b.dev))
    sp = tag(p)
    b.workload({f"scatteradd_index_add_{sp}x10_to_{tag(n_rows)}":
                    lambda: torch.zeros(n_rows, 10, device=b.dev).index_add_(
                        0, seg, vals),
                f"scatteradd_sort_segment_reduce_{sp}x10":
                    lambda: slot_grads_to_rows(vals, seg, n_rows),
                f"scatteradd_seg_pos_segment_reduce_{sp}x10":
                    lambda: slot_grads_to_rows(vals, seg, n_rows,
                                               seg_pos=seg_pos)},
               close_rows)
    del seg, seg_pos, vals

    t_rows = b.size(TILES)
    tbl = b.randint(0, 1 << 20, (t_rows, 2 * K))
    b.workload({f"dim1sort_stable_{t_rows}x{2 * K}":
                    lambda: torch.sort(tbl, dim=1, stable=True).values,
                f"dim1sort_{t_rows}x{2 * K}":
                    lambda: torch.sort(tbl, dim=1).values}, equal)
    del tbl

    d5 = b.randint(0, 2 ** 31 - 1, (m, 5))
    d5_cm = d5.T.contiguous()
    keys_p = keys_m[:p].contiguous()
    b.workload({f"bwd_sort6op_index_select_{s}": sort_rows(keys_m, d5),
                f"bwd_sort6op_argsort_gather_cm_{s}":
                    argsort_gather_cm(keys_m, d5_cm)}, equal)
    b.workload({f"bwd_sort6op_index_select_{sp}":
                    sort_rows(keys_p, d5[:p].contiguous()),
                f"bwd_sort6op_argsort_gather_cm_{sp}":
                    argsort_gather_cm(keys_p, d5_cm[:, :p].contiguous())},
               equal)
    b.workload({f"bwd_sort11op_index_select_{sp}":
                    sort_rows(keys_p, rows[:p].contiguous()),
                f"bwd_sort11op_argsort_gather_cm_{sp}":
                    argsort_gather_cm(keys_p, cm[:, :p].contiguous())},
               equal)
    del d5, d5_cm, keys_p, keys_m, rows, cm, plan, pos

    src = b.normal((n_rows, 10))
    gidx = b.randint(0, n_rows, p, torch.int64)
    gsort = torch.sort(gidx).values
    for name, g in (("rand", gidx), ("tilesorted", gsort)):
        b.workload({f"attr_rowgather_{sp}x10_{name}":
                        lambda g=g: src.index_select(0, g),
                    f"attr_index_{sp}x10_{name}": lambda g=g: src[g]},
                   equal)


def binning_primitives(b: Bench) -> None:
    """``ops/binning.py``'s sorts and search at 1M rows, 1920x1088: the
    stable depth sort (culled rows at +inf), the per-row sort of each
    row's scanned tile ids, the packed (tile, rank) key sort of every
    emitted slot and the tile boundaries' ``searchsorted``."""
    n = b.size(ROWS)
    t_total = b.size(TILES)
    depth_t = 1.0 + 199.0 * b.rand(n)
    depth_t[b.rand(n) < 0.3] = float("inf")
    b.workload({f"bin_depth_sort_stable_{tag(n)}":
                    lambda: torch.sort(depth_t, stable=True).indices,
                f"bin_depth_argsort_stable_{tag(n)}":
                    lambda: torch.argsort(depth_t, stable=True)}, equal)
    del depth_t
    rank_bits = max(1, (n - 1).bit_length())
    for cname, (max_dup, overscan, tails) in BIN_CONFIGS.items():
        scan = max_dup * overscan
        tid_t = b.randint(0, t_total, (n, scan))
        tid_t[b.rand((n, scan)) < 0.5] = 2 ** 31 - 1
        b.workload({f"bin_row_tile_sort_{cname}_{tag(n)}x{scan}":
                        lambda: torch.sort(tid_t, dim=1).values,
                    f"bin_row_tile_sort_stable_{cname}_{tag(n)}x{scan}":
                        lambda: torch.sort(tid_t, dim=1, stable=True).values},
                   equal)
        del tid_t
        m = n * max_dup + sum(min(bud, n) * w for bud, w in tails)
        packed = ((b.randint(0, t_total + 1, m, torch.int64) << rank_bits)
                  | b.randint(0, n, m, torch.int64))
        lo32 = (1 << 32) - 1

        def two_halves():
            i1 = torch.sort(packed & lo32, stable=True).indices
            i2 = torch.sort(packed.index_select(0, i1) >> 32,
                            stable=True).indices
            return packed.index_select(0, i1.index_select(0, i2))

        b.workload({f"bin_packed_key_sort_{cname}_{tag(m)}":
                        lambda: torch.sort(packed).values,
                    f"bin_packed_key_sort_stable_{cname}_{tag(m)}":
                        lambda: torch.sort(packed, stable=True).values,
                    f"bin_packed_key_two_halves_{cname}_{tag(m)}":
                        two_halves}, equal)
        sorted_vals = torch.sort(packed).values
        del packed
        probes = torch.arange(t_total + 1, dtype=torch.int64,
                              device=b.dev) << rank_bits

        def by_bincount():
            c = torch.bincount(sorted_vals >> rank_bits,
                               minlength=t_total + 1)[:t_total + 1]
            return torch.cat([c.new_zeros(1), torch.cumsum(c, 0)[:-1]])

        b.workload({f"bin_searchsorted_{cname}_{t_total + 1}_in_{tag(m)}":
                        lambda: torch.searchsorted(sorted_vals, probes),
                    f"bin_bucketize_{cname}_{t_total + 1}_in_{tag(m)}":
                        lambda: torch.bucketize(probes, sorted_vals),
                    f"bin_bincount_cumsum_{cname}_{tag(m)}": by_bincount},
                   equal)
        del sorted_vals


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiply every size (the tests run it tiny)")
    args = ap.parse_args(argv)
    b = Bench(resolve_device(args.device), args.scale)
    pair_sorts(b)
    backward_reduce(b)
    binning_primitives(b)
    print({k: round(v, 3) for k, v in b.ms.items()}, flush=True)
    return {"ms": b.ms, "checks": b.checks}


if __name__ == "__main__":
    main()
