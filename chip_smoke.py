#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's forward LOD render path, its training path, its
street-scale tools path, its hierarchy back end (post-optimization,
merge, evaluation), its command line (the five-stage ``full-train``,
``render-hierarchy``, the live viewer) and its multi-rank layer
(``parallel/``), its web viewer, its preprocessing and its root drivers
(``tools/``) on the card and holds every hand-written kernel against its
plain PyTorch version:

1. build   — compile ``street_sparse_3dgs_tpu_torch/csrc/*.cu`` (one nvcc per
             source, in parallel) into the ignored ``build/kernels/``;
2. kernels_small — K1 (padded blend), K2 (its backward), K3 (exact blend),
             K4 (its backward), K5 (slab gather, with its edge cases: K in
             {128, 384, 1024, 100}, empty rows, rows over K, segments flush
             with the end of the keys) and the kernel-floor stubs D1-D3 on
             small inputs against their plain versions; K2 and K4 launched
             twice (bit-identical), K4 also in another tile order (equal);
             K2 also with faint wide slots (opacity 1/255 +- 1e-6, alphas
             on both sides of the 1/255 test) and at K = 100; K3's window
             split at groups of 1, 2 and 3 windows against its plain twin
             and the plain version; D1-D3 at groups of 0 (no split), 1, 2, 3 and
             4 windows and 1, 2, 4, 8 table rows a block;
3. grads_small — ``rasterize`` and its backward on a toy scene in the
             padded and the exact+counts config, on the card (kernels) and
             on the CPU (plain versions);
4. render  — the street scene (1M Gaussians, 4 views, 1920x1088) through
             ``rasterize(method="pallas")`` in the production exact config
             (K3) and a padded config (K1); every image is compared with the
             plain path on the same inputs, each view's ``bin_scan`` with
             ``bin_scan_plain`` (exactly); ``project_fwd`` launched;
5. hierarchy — a LOD hierarchy over the same rows, saved to ``.hier.npz``
             and loaded back, rendered per view at tau in {0, 3, 6, 15}
             through ``pixel_limit -> select_cut -> render_cut_compact``;
6. layers  — the stages of one street render timed apart, and a profile
             of it (device time by op, device idle share);
7. kernel_floor — ``tools/kernel_floor``'s measurements on phase 4's view-0
             exact binning: the real K3 (with and without its split)
             against the stubs on K3's own kernels, D1 (channel-major,
             levels 2..-2), D2 (pair-major, levels 2, 0, -1), D3 (level
             0, 1/2/4/8 table rows a block), D1, D2 level 2 without the
             split and D1, D2 at the math level 3 (K3's own per-step work
             up to its termination, on level 0's walk), each held against
             its plain version, and the mechanics / loads / math split,
             each field named for the probe and layout it reads;
8. train_street — 12 steps of ``make_train_step`` on the street scene in
             the production config (K5, K3, K4), GT from the plain forward;
9. train_bench — 20 steps in the bench.py config (512x512, 32k Gaussians,
             padded, K = 384: K5, K1, K2);
10. train_loop_toy — ``train_loop`` for 300 iterations with densification
             on a 64x64 toy scene (K5, K1, K2);
11. train_street_auto — ``tools/train_street`` at full width (1M-row street
             scene at 960x544, 4 views, GT through the self-sized exact path,
             a 100k-point start at capacity 262,144) in two invocations of
             AUTO_SLICE iterations with ``exact_extra=-1`` (the second
             densifies); between them a checkpoint saved, reloaded and held
             bit for bit against the state, and 10 steps from each giving
             bit-identical losses; ``too_far_mask`` card against CPU;
12. post_opt — the back end's stage 4 at full width: a COLMAP project of
             the 4 street views (PINHOLE 1920x1088, 100k points, GT the tau 0
             renders of phase 5's tree as 8-bit PNGs, 16-bit inverse-depth
             PNGs, test.txt naming view 3) written with the port's
             ``data/colmap`` and ``data/png`` and loaded back through
             ``load_scene_info`` and ``CameraStream`` (view matrices to 1e-5,
             images exactly); the rows split at the median x into two chunks,
             a hierarchy built and saved for each; on chunk 0 the compacted
             render against the mask form (images, grads); 40 steps of
             ``CompactPostDriver`` (production exact counts config, K5, K3,
             K4) from an eighth of the default capacity, which grows and
             redoes, bit-identical to a run started at the grown capacity;
             anchors frozen, the photometric loss lower after; the optimised
             tree saved and reloaded; ``tools/post_scaling`` (mask against
             compacted step at 32k, 131k, 524k leaves);
13. merge_eval — ``merge_hierarchies`` of the two chunks (node count, one
             root, the cut each chunk's own and a partition at limits 0 and
             1e9, at 0.05 wherever the cut metric is monotone along the
             path; ``.hier.npz`` round trip), the tau sweep ``render_hierarchy_eval`` on the project's test view with
             LPIPS (K5, K3; TF32 off, finite metrics, tau 0 PSNR >= 25 dB)
             and one ``render_position`` call;
14. full_train — the command line over a two-chunk project at full width
             (``write_chunked_project``: phase post_opt's 4 views, PNGs and
             cameras, masks over the GT's empty sky; the 1M rows as the
             aligned cloud, each chunk its half at the median x):
             ``cli.main(["full-train", ...])`` in the production exact
             counts config (K5, K3, K4) with the budgets the autosizer
             measures on the coarse stage's initial rows, depth cut to
             FT_COARSE / FT_CHUNK / FT_POST steps; ``render-hierarchy`` of
             the merged tree at tau {0, 3, 6, 15} with LPIPS; a rerun that
             skips every stage; ``python -m street_sparse_3dgs_tpu_torch.cli
             render-hierarchy`` in a subprocess; ``train-single`` with the
             live viewer on while a client asks for 1920x1088 frames, and
             ``ViewerHook`` on its saved state against the plain render;
             each stage's first K3, K4 and K5 call held against its plain
             version when the stage ends, chunk 0's training calls kept
             for phase 15;
15. parallel — ``parallel/`` in three spawned worlds of ranks sharing the
             card (``parallel.mesh.run_world``; the parent builds the
             kernels first, ranks only load them): 2 ranks on gloo at full
             width (``rasterize_tile_sharded`` padded, K = 1024, and exact,
             forward and the backward of mean(render^2) against the serial
             ``rasterize``; the exact counts ``make_tile_sharded_train_step``
             (1 x 2) for PAR_STEPS steps against the serial
             ``make_train_step``; ``make_dp_train_step`` (2 x 1); the ring
             render and ``make_ring_train_step`` at a ``max_dup`` and K
             sized so that nothing overflows, against the serial path; the
             dry run ``parallel/dryrun``), 1 rank on nccl (the DP step twice,
             bit-identical, the reference of the gloo DP step; the
             tile-sharded render) and 4 ranks on gloo at 200k rows, 960x544
             (the (2 x 2) tp steps, padded and exact counts, against the
             nccl rank's DP step on the same batch).  Losses at rtol 1e-5,
             params within one Adam quantum, denom equal; each rank's first
             K1 (tile0 > 0; t_mod with per-tile backgrounds), K3 (a rank's
             order; t_mod), K2 and K4 held against the plain versions, and a
             rank's K4 against the whole view's K4 on its windows bit for
             bit; step ms, host transport, peak memory and launches per
             rank.  A rank's failure or a world past PAR_TIMEOUT fails it;
16. viewer_app — ``viewer/app.py``'s ``ViewerApp`` on port 0 in this
             process over phase 5's street hierarchy (``.hier.npz``) and the
             1M rows as ``point_cloud.ply`` (``SceneSource`` on the card,
             ``RasterConfig(method="pallas")``: K5, K1); a client thread
             POSTs ``/frame`` at 1920x1088 from view 0's pose at tau 0, 3,
             6, 15, one ``--budget`` cut and the leaf source; each source's
             first frame against the render of the same cut through the
             plain versions (one level at all but 1e-4 of the pixels), its
             K5 and K1 calls against the plain versions, then 5 timed
             requests (the same frame; median request-to-frame ms split
             into cut, render (device time), encode and the rest beside the
             33 ms of a 30 frames/s viewer), the JPEG decoded by the port's
             decoder (PSNR >= 30 dB), ``x-status`` against
             ``last_overflow``; launches and peak memory;
17. preprocess — the preprocessing slice on a synthetic street project at
             the JAX code's default sizes: ``generate_colmap_from_
             calibration`` in eval mode (200 recordings 5 m apart, 8 faces
             of 2048 px: 1,600 PINHOLE views), 64 faces through the port's
             JPEG encoder and decoder, 1M SfM points with tracks, 4 LAZ
             tiles of 2.5M points (format 3) written and read by the port's
             codec, ``depth_pipeline.generate_depths`` (virtual depth
             cameras, vis2mesh cameras), ``make_chunks`` at chunk size 100
             with the LiDAR merge, 64 Cyclomedia depth maps of the
             faces' 2048 px through ``depth_decode`` and
             ``make_depth_scale``, Depth-Anything vitl
             (random weights saved in the original repo's naming) through
             ``mono_depth.generate_depth`` on the card over 16 faces at
             target 518 and a 4-layer vitl-width model card against CPU,
             ``mask_images.process_images`` over 64 faces with precomputed
             detections, and the CTM export of a 2M-triangle mesh (native
             against plain bytes); each step timed;
18. bench — ``tools/bench`` (bench.py's 512x512, 32k rows, padded K = 384,
             ``max_dup`` 32: K5, K1, K2): JAX's four keys first, finite
             grads, the overflow counters (it truncates);
19. bench_street — ``tools/bench_street`` on phase 4's scene at 1920x1088,
             4 cameras round-robin: the tool's padded default (``max_dup``
             16, K = 384: K5, K1, K2) and the production exact config
             (K5, K3, K4; no tile overflow in a counts step) with its
             profile;
20. microbench — ``tools/microbench`` at its full sizes (sorts, the
             backward's reductions, layouts, gathers, the binning's
             primitives): every candidate held against its reference
             before it is timed; no kernel may launch;
21. parity — ``tools/parity`` (oracle, tiled, kernels padded and exact at
             128x96: K1-K5): JAX's bar;
22. convergence — ``tools/convergence`` with the three methods side by
             side, CONV_ITERS of 1,500 iterations each: finite PSNR, the
             gaps to tiled recorded (not gated);
23. pipeline_quality — ``tools/pipeline_quality`` (pallas padded: K5, K1,
             K2) over its synthetic project at 1/TOOL_DEPTH_CUT depth:
             every artifact, finite metrics, tau 15 <= tau 0 + 0.1 dB, a
             rerun that skips every stage;
24. fork_features — ``tools/fork_features`` both arms (pallas exact: K5,
             K3, K4) at the same cut, ``results.json`` per arm, the
             report, a rerun that skips;
25. kernels_street — K1-K5 timed at the shapes of phases 4, 8, 9 (and
             ``bin_scan`` at phase 4's view 0, held exactly; ``project_fwd``
             and ``project_bwd`` on phase 4's rows and view 0, held against
             the plain path as tests/test_torch_project_card.py holds them,
             beside their byte bounds and the plain versions), and K3,
             K4 at those of phases 11, 12 and 14, K1 at phase 9's and 16's,
             K2 at phase 10's, K5 at phase 16's, and each kernel at the
             shapes of its first call in each of phases 18-24 (held
             against the plain version there too):
             ``ms`` is device time (``profiling.device_ms``), ``wall_ms``
             the events around back-to-back calls, host cost included; K2
             beside its launch floor (the same call with every count 0); K3
             and K4 launched twice (bit-identical) and over their deepest
             tile alone (its share of the launch); K1-K4: the walked and
             the passing (slot, pixel) steps and the share of walked
             warp-slots where a pixel passes the alpha test, from which
             the bound is counted; K3 also deepest first, and against the
             split's plain twin;
26. the kernels line (launches counted on phases 4, 5, 7, 8, 9, 10, 11,
             12, 13, 14, 15, 16 and 18-24 only, error against the plain
             version, times, bound; K1-K4 with their ``at_parallel`` calls,
             K1 and K5 with their ``at_viewer_app`` calls, each kernel with
             its ``at_<tool phase>`` calls) and the device line.

Every phase prints one JSON line.  Any failure raises and exits nonzero.
Without a CUDA card it exits 1 before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import shutil
import statistics
import sys
import threading
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# Work a blend needs per (slot, pixel) step, forward and backward: every
# walked step evaluates the power (dx, dy, six products, two sums); a step
# that passes the alpha test also needs exp(power), log1p(-alpha) and
# exp(log T) and the rest of its blend (forward: alpha, the weight, five
# sums; backward: the ten partials).
FLOPS_PER_WALK = 11
SFU_PER_PASS = 3
FLOPS_PER_PASS = 15
BWD_FLOPS_PER_PASS = 50

IMG_ATOL = 2e-5                  # tests/test_pallas_blend.py forward bar
FLIP_SHARE = 1e-4                # pixels allowed to differ by a T=1e-4 flip
GRAD_BAR = 3e-4                  # x max|g| (tests/test_pallas_blend.py:60)
GRAD_RTOL = 2e-3

STREET = dict(method="pallas", max_dup=2, tile_capacity=128, dup_overscan=32,
              dup_tails=((262144, 6), (16384, 24), (4096, 224)))
TAUS = (0.0, 3.0, 6.0, 15.0)
TIMED_RUNS = 5
DEVICE = "cuda"
N_ROWS, N_VIEWS, WIDTH, HEIGHT = 1_000_000, 4, 1920, 1088
# bench.py:71-76: 512x512, 32k Gaussians, padded pallas, K = 384.
BENCH_N, BENCH_RES = 32768, 512
SMALL_N, SMALL_W, SMALL_H = 2048, 256, 192
STREET_STEPS, BENCH_STEPS, WARMUP_STEPS, LOOP_ITERS = 12, 20, 2, 300
AUTO_SLICE, RESUME_STEPS = 120, 10       # train_street_auto
POST_STEPS, POST_POINTS, N_ANCHORS = 40, 100_000, 1000   # post_opt
# tests/test_hierarchy.py::test_compact_cut_render_matches_mask's bars.
COMPACT_GRAD_BAR, COMPACT_GRAD_RTOL = 5e-4, 2e-3
PSNR_TAU0_MIN = 25.0             # merge_eval: the GT is tau 0 of these rows
POSITION_SHIFT = 2.0             # metres along x for render_position
K5_EDGE_KS = (128, 384, 1024, 100)
# full_train: steps of the coarse, chunk and post stages (densify rounds at
# FT_DENSIFY), of the viewer's train-single run, the frames its client asks
# for, and the least tau 0 PSNR of the partial run.
FT_COARSE, FT_CHUNK, FT_DENSIFY, FT_POST = 30, 45, (15, 30), 20
FT_VIEWER_STEPS, FT_FRAMES, FT_PSNR_MIN = 20, 3, 5.0
# The project's GT has no sky (the renders' background is black), so no
# skybox dome (full-train's default is 100,000 rows, far wider on screen
# than the scene: their pairs overflow the post steps' windows).  The
# emission ladder and window budget are the autosizer's for the coarse
# stage's initial rows (kNN scales, far wider than the street scene's own),
# with FT_MARGIN headroom for the chunk trees (ring, own rows, densified):
# the post stage cannot grow a budget.
FT_SKYBOX, FT_MARGIN = 0, 2.0
FT_TIMED = "chunk_0_0_train"     # the stage whose first calls are timed


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def timed_runs(fn, runs: int = TIMED_RUNS):
    """(median ms over ``runs`` event-timed calls after a warm-up, last
    result)."""
    out = fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def device_profile(fn) -> dict:
    """One call of ``fn`` under ``profiling.trace_fn``: wall ms, device
    busy ms (the kernels' own device-side spans), idle share, and the host
    ops with the most device self time."""
    from street_sparse_3dgs_tpu_torch import profiling
    return profiling.device_summary(profiling.trace_fn(fn, iters=1,
                                                       warmup=0))


class Recorder:
    """Wraps ``module.name`` so every call's arguments and result are kept
    while the ``with`` block runs (the comparison harness only);
    ``first_only`` keeps the first call alone, detached, so that no autograd
    graph outlives its step.  ``calls`` holds (positional arguments,
    result); ``kwargs`` each call's keyword arguments (a launch ``order``,
    a ``tile0``)."""

    def __init__(self, module, name: str, first_only: bool = False):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.first_only = first_only
        self.calls: list = []
        self.kwargs: list = []

    def __enter__(self):
        def detach(x):
            return x.detach() if isinstance(x, torch.Tensor) else x

        def wrapped(*args, **kw):
            out = self.fn(*args, **kw)
            if not self.first_only:
                self.calls.append((args, out))
                self.kwargs.append(kw)
            elif not self.calls:
                self.calls.append((tuple(detach(x) for x in args),
                                   out.detach()))
                self.kwargs.append({k: detach(v) for k, v in kw.items()})
            return out

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)
        return False


def compare_blend(k_out: torch.Tensor, p_out: torch.Tensor) -> dict:
    """Kernel vs plain packed rows [T, 8, 256], per pixel over rows R, G, B,
    invdepth, alpha and log T.  ``flips`` counts pixels whose n_contrib
    differs: a termination flip at T ~ 1e-4, where the kernel's running sum
    of log(1 - alpha) and the plain version's cumsum round differently."""
    err = (k_out[:, :6] - p_out[:, :6]).abs().amax(dim=1)      # [T, 256]
    flip = k_out[:, 6] != p_out[:, 6]
    zero = torch.zeros_like(err)
    return dict(max_abs_err=float(err.max()),
                pixels_over_atol=int((err > IMG_ATOL).sum()),
                pixels=int(err.numel()), flips=int(flip.sum()),
                max_err_without_flips=float(torch.where(flip, zero,
                                                        err).max()))


def check_blend(name: str, cmp: dict, strict: bool) -> None:
    """Every pixel within IMG_ATOL (strict), or all but FLIP_SHARE of
    them."""
    limit = 0 if strict else FLIP_SHARE * cmp["pixels"]
    if cmp["pixels_over_atol"] > limit:
        raise AssertionError(f"{name}: {cmp['pixels_over_atol']} pixels "
                             f"over {IMG_ATOL} (limit {limit}): {cmp}")


def compare_grads(name: str, got: torch.Tensor, want: torch.Tensor,
                  axis: int) -> dict:
    """Kernel vs plain per-slot grads, channel on ``axis``: per channel the
    largest |got - want| over max|want| of that channel; fails above
    GRAD_BAR (JAX's gradient bar)."""
    ch = got.shape[axis]
    g = got.movedim(axis, -1).reshape(-1, ch).double()
    w = want.movedim(axis, -1).reshape(-1, ch).double()
    scale = w.abs().amax(dim=0).clamp_min(1e-30)
    err = ((g - w).abs().amax(dim=0) / scale).tolist()
    if max(err) > GRAD_BAR:
        raise AssertionError(f"{name}: scaled grad error {err} over "
                             f"{GRAD_BAR}")
    return {"max_scaled_err": max(err), "per_channel": err,
            "max_abs_err": float((g - w).abs().max())}


def bound(bytes_: int, sfu: int, flops: int, sfu_rate: float):
    """(bound ms, bound_by): the larger of bytes over the card's memory
    rate and the operations over their peak rates (``sfu``
    special-function results, ``flops`` f32 operations)."""
    from street_sparse_3dgs_tpu_torch.profiling import (PEAK_BYTES_S,
                                                        PEAK_FLOP_S)
    t_bytes = bytes_ / PEAK_BYTES_S
    t_ops = max(sfu / sfu_rate, flops / PEAK_FLOP_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def tile_pairs(vcounts, wt, last_v) -> torch.Tensor:
    """Pairs of each real tile of an exact layout: its windows' counts."""
    last = last_v.to(torch.int64)
    csum = torch.cat([torch.zeros(1, dtype=torch.int64, device=last.device),
                      torch.cumsum(vcounts.to(torch.int64), 0)])
    return csum[last + 1] - csum[last - wt[last]]


# ---- training harness -----------------------------------------------------

def camera_batches(cams, gts, dev) -> list:
    """One ``CameraBatch`` per view: the GT image, no alpha mask and no
    depth supervision."""
    from street_sparse_3dgs_tpu_torch.train.step import CameraBatch
    out = []
    for i, (cam, gt) in enumerate(zip(cams, gts)):
        shape = (1, cam.height, cam.width)
        out.append(CameraBatch(
            camera=cam, gt_image=gt,
            alpha_mask=torch.ones(shape, device=dev),
            mono_invdepth=torch.zeros(shape, device=dev),
            depth_mask=torch.zeros(shape, device=dev),
            depth_reliable=torch.tensor(False, device=dev),
            image_index=torch.tensor(i, device=dev)))
    return out


def plain_render(rows, cam, cfg, bg) -> torch.Tensor:
    """[3, H, W] image in [0, 1] of the plain forward: projection, binning
    and packing as ``rasterize`` does them, then ``blend_*_plain``, so that
    no blend kernel makes the GT of the kernels' training."""
    from street_sparse_3dgs_tpu_torch.ops import binning
    from street_sparse_3dgs_tpu_torch.ops import cuda_blend as cb
    from street_sparse_3dgs_tpu_torch.ops.preprocess import project_gaussians
    with torch.no_grad():
        proj = project_gaussians(*rows, cam, 3)
        kw = dict(vis_capacity=cfg.vis_capacity, exact_extra=cfg.exact_extra,
                  dup_overscan=cfg.dup_overscan)
        if cfg.dup_tails:
            kw["dup_tails"] = cfg.dup_tails
        bins = binning.bin_gaussians(proj, cam.height, cam.width, cfg.max_dup,
                                     cfg.tile_capacity, **kw)
        exact = bins.t_of_v is not None
        attrs = cb.pack_gather_attrs(
            bins.gather, proj.mean2d, proj.conic, proj.color, proj.opacity,
            proj.inv_depth, order=bins.order, rank=bins.rank,
            pair_major=exact)
        bg2 = bg.reshape(1, 3)
        if exact:
            flat = cb.blend_exact_plain(attrs, bins.vcounts, bins.wt,
                                        bins.last_v, bg2, bins.tiles_x)
        else:
            flat = cb.blend_padded_plain(attrs, bins.counts.to(torch.int32),
                                         bg2, bins.tiles_x)
        img = cb._to_image(flat[:, :3], bins.tiles_x, bins.tiles_y,
                           cam.height, cam.width)
    return torch.clamp(img, 0.0, 1.0)


def start_params(rows, seed: int, dev):
    """The trainee's start: the scene's rows with colours (the SH DC band)
    and opacities perturbed by a generator seeded with ``seed``; scales and
    opacities turned back into raw parameters (log, inverse sigmoid)."""
    from street_sparse_3dgs_tpu_torch.models.gaussians import (
        GaussianParams, inverse_sigmoid)
    means, scales, quats, opac, sh = rows
    g = torch.Generator().manual_seed(seed)
    dc = sh[:, :1] + 0.3 * torch.randn(tuple(sh[:, :1].shape),
                                       generator=g).to(dev)
    op = opac * (0.5 + torch.rand(tuple(opac.shape), generator=g).to(dev))
    op = torch.clamp(op, 0.02, 0.98)
    return GaussianParams(xyz=means.clone(), features_dc=dc,
                          features_rest=sh[:, 1:].clone(),
                          log_scales=torch.log(scales), quats=quats.clone(),
                          opacity_raw=inverse_sigmoid(op)[:, None])


def event_spans(targets: dict, run) -> tuple:
    """Runs ``run()`` with each ``targets`` entry (key -> (owner, attribute
    name)) wrapped in a pair of CUDA events: (per key the list of its
    (start, end) events, the run's start event, its end event).  Every
    attribute is put back after the run."""
    def ev():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    spans = {k: [] for k in targets}
    saved = {k: (getattr(o, n), n in vars(o))
             for k, (o, n) in targets.items()}

    def timed(key):
        fn = saved[key][0]

        def wrapped(*args, **kw):
            s = ev()
            out = fn(*args, **kw)
            spans[key].append((s, ev()))
            return out
        return wrapped

    for k, (o, n) in targets.items():
        setattr(o, n, timed(k))
    try:
        torch.cuda.synchronize()
        start = ev()
        run()
        end = ev()
        torch.cuda.synchronize()
    finally:
        for k, (o, n) in targets.items():
            fn, own = saved[k]
            if own:
                setattr(o, n, fn)
            else:       # a method of the owner's class
                delattr(o, n)
    return spans, start, end


def step_stages(step, state, batch, bg, bwd_name: str) -> dict:
    """Device-time split of one training step by CUDA events: set-up,
    forward (render + loss), the backward blend kernel, the slot->row
    reduction, the rest of the backward, and what follows the grads (masks,
    Adam, exposure Adam, densify statistics)."""
    from street_sparse_3dgs_tpu_torch.ops import cuda_blend as cb
    spans, start, end = event_spans(
        {bwd_name: (cb, bwd_name),
         "slot_grads_to_rows": (cb, "slot_grads_to_rows"),
         "forward": (step, "forward"),
         "value_and_grad": (step, "value_and_grad")},
        lambda: step(state, batch, bg=bg))
    fwd0, fwd1 = spans["forward"][-1]
    bwd1 = spans["value_and_grad"][-1][1]
    kern = sum(s.elapsed_time(e) for s, e in spans[bwd_name])
    red = sum(s.elapsed_time(e) for s, e in spans["slot_grads_to_rows"])
    return {"setup": start.elapsed_time(fwd0),
            "forward": fwd0.elapsed_time(fwd1),
            bwd_name: kern, "slot_grads_to_rows": red,
            "backward_rest": fwd1.elapsed_time(bwd1) - kern - red,
            "adam_and_stats": bwd1.elapsed_time(end),
            "total": start.elapsed_time(end)}


def train_phase(phase: str, rows, cams, pipe, n_steps: int,
                spatial_lr_scale: float, dev, bwd_name: str,
                exact_counts: bool) -> dict:
    """``n_steps`` of ``make_train_step`` round-robin over ``cams`` from a
    perturbed start towards GT images of the plain forward, launches
    counted; then (uncounted) the stage split, the device idle share of one
    profiled step and two backwards of view 0 compared bit for bit.  Fails
    unless every loss is finite and the mean loss of the last 4 steps is
    below that of the first 4 (and, in exact counts mode, no step
    overflowed or skipped its update)."""
    from street_sparse_3dgs_tpu_torch import native
    from street_sparse_3dgs_tpu_torch.config import OptimizationConfig
    from street_sparse_3dgs_tpu_torch.models.gaussians import GaussianMeta
    from street_sparse_3dgs_tpu_torch.ops import cuda_blend as cb
    from street_sparse_3dgs_tpu_torch.train.step import (init_state,
                                                         make_train_step,
                                                         raster_config)
    t0 = time.perf_counter()
    bg = torch.zeros(3, device=dev)
    rcfg = raster_config(pipe)
    gts = [plain_render(rows, cam, rcfg, bg) for cam in cams]
    torch.cuda.synchronize()
    gt_s = time.perf_counter() - t0
    batches = camera_batches(cams, gts, dev)
    params = start_params(rows, 1, dev)
    n = params.xyz.shape[0]
    state = init_state(params, torch.ones(n, dtype=torch.bool, device=dev),
                       len(cams))
    step = make_train_step(GaussianMeta(sh_degree=3, capacity=n),
                           OptimizationConfig(), pipe, spatial_lr_scale,
                           sh_degree_schedule=False, random_background=False)
    if torch.backends.cudnn.allow_tf32 or \
            torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError(f"{phase}: the training entry left TF32 on")

    native.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    step_ms, auxs = [], []
    for i in range(n_steps):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        state, aux = step(state, batches[i % len(batches)], bg=bg)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - s0) * 1e3)
        auxs.append(aux)
    launches = dict(native.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for name in ("slab_gather", bwd_name, bwd_name.replace("_bwd", "")):
        if launches[name] == 0:
            raise AssertionError(f"{phase}: the training path never "
                                 f"launched {name}")

    def per_step(key):
        return [int(a[key]) for a in auxs] if key in auxs[0] else None

    losses = [float(a["loss"]) for a in auxs]
    skipped, tile_of = per_step("update_skipped"), per_step("tile_overflow")
    first, last = statistics.mean(losses[:4]), statistics.mean(losses[-4:])
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{phase}: non-finite loss {losses}")
    if not last < first:
        raise AssertionError(f"{phase}: loss did not fall ({first} -> "
                             f"{last}): {losses}")
    if exact_counts and (any(skipped) or any(tile_of)):
        raise AssertionError(f"{phase}: update_skipped {skipped}, "
                             f"tile_overflow {tile_of}")

    stages = step_stages(step, state, batches[0], bg, bwd_name)
    prof = device_profile(lambda: step(state, batches[0], bg=bg))
    with Recorder(cb, bwd_name) as kb, \
            Recorder(cb, "slot_grads_to_rows") as red:
        step(state, batches[0], bg=bg)
        step(state, batches[0], bg=bg)
    torch.cuda.synchronize()
    emit({"phase": phase, "seconds": time.perf_counter() - t0,
          "gt_seconds": gt_s, "rows": n, "views": len(cams),
          "width": cams[0].width, "height": cams[0].height,
          "config": {k: v for k, v in vars(pipe).items()},
          "spatial_lr_scale": spatial_lr_scale, "steps": n_steps,
          "step_ms": step_ms,
          "step_ms_median": statistics.median(step_ms[WARMUP_STEPS:]),
          "losses": losses, "loss_first4": first, "loss_last4": last,
          "update_skipped": skipped, "tile_overflow": tile_of,
          "dup_overflow": per_step("dup_overflow"),
          "n_visible": per_step("n_visible"),
          "peak_memory_bytes": peak, "launches": launches,
          "stage_ms": stages, **prof,
          "bwd_kernel_bit_identical": torch.equal(kb.calls[0][1],
                                                  kb.calls[1][1]),
          "slot_to_row_grads_bit_identical": torch.equal(red.calls[0][1],
                                                         red.calls[1][1])})
    # The saved attrs require grad: detached, so the plain version timed
    # on them later builds no autograd graph.
    args, out = kb.calls[0]
    args = tuple(x.detach() if isinstance(x, torch.Tensor) else x
                 for x in args)
    return {"args": args, "out": out, "launches": launches}


def train_loop_toy(dev) -> dict:
    """The port's ``train_loop`` on the GT and init of
    tests/test_train.py:313-361 (a 64x64, 200-Gaussian toy scene, oracle GT,
    a noisy point cloud) through the padded kernels, with densification.
    Fails unless the loss EMA (0.97) ends below 0.75x its value at
    iteration 20.  Returns {"launches": the phase's launches, "k2_call": the
    first K2 call (args, result) at its shapes}."""
    from street_sparse_3dgs_tpu_torch import native
    from street_sparse_3dgs_tpu_torch.config import (ModelConfig,
                                                     OptimizationConfig,
                                                     PipelineConfig)
    from street_sparse_3dgs_tpu_torch.data.toy import make_toy_scene
    from street_sparse_3dgs_tpu_torch.models.gaussians import create_from_pcd
    from street_sparse_3dgs_tpu_torch.ops import cuda_blend as cb
    from street_sparse_3dgs_tpu_torch.ops.rasterize import (RasterConfig,
                                                            rasterize)
    from street_sparse_3dgs_tpu_torch.train.loop import LoopHooks, train_loop
    from street_sparse_3dgs_tpu_torch.train.step import init_state
    t0 = time.perf_counter()
    scene = make_toy_scene(seed=2, n=200, n_cameras=3, width=64, height=64,
                           device=dev)
    rows = (scene.means3d, scene.scales, scene.quats, scene.opacities,
            scene.sh_coeffs)
    gts = [torch.clamp(rasterize(*rows, c, 3, torch.zeros(3, device=dev),
                                 RasterConfig(method="oracle"))["render"],
                       0.0, 1.0) for c in scene.cameras]
    g = torch.Generator().manual_seed(0)
    pts = scene.means3d + 0.02 * torch.randn((200, 3), generator=g).to(dev)
    params, active, meta = create_from_pcd(
        pts, torch.full((200, 3), 0.5, device=dev), capacity=256)
    state = init_state(params, active, n_images=3)
    opt = OptimizationConfig(
        iterations=LOOP_ITERS, densification_interval=50,
        densify_from_iter=50, densify_until_iter=260,
        opacity_reset_interval=10_000, densify_grad_threshold=2e-4)
    pipe = PipelineConfig(raster_method="pallas", tile_capacity=128,
                          max_dup=32)
    rounds = []
    native.reset_launches()
    # The loop's progress lines go to stderr: stdout holds the JSON lines.
    with contextlib.redirect_stdout(sys.stderr), \
            Recorder(cb, "blend_padded_bwd", first_only=True) as k2:
        state, meta, stats = train_loop(
            state, meta, camera_batches(scene.cameras, gts, dev), opt, pipe,
            ModelConfig(), cameras_extent=3.0, spatial_lr_scale=1.0,
            clamp_fraction=1.0, rng_seed=0,
            hooks=LoopHooks(on_densify=lambda it, n: rounds.append([it, n])))
    torch.cuda.synchronize()
    launches = dict(native.LAUNCHES)
    for name in ("slab_gather", "blend_padded", "blend_padded_bwd"):
        if launches[name] == 0:
            raise AssertionError(f"train_loop_toy never launched {name}")
    ema, ema20 = None, None
    for i, x in enumerate(stats["losses"]):
        ema = x if ema is None else 0.97 * ema + 0.03 * x
        if i == 19:
            ema20 = ema
    if not (len(stats["losses"]) == LOOP_ITERS and ema < 0.75 * ema20):
        raise AssertionError(f"train_loop_toy: loss EMA {ema20} -> {ema} "
                             f"(bar 0.75x) over {len(stats['losses'])} "
                             "iterations")
    emit({"phase": "train_loop_toy", "seconds": time.perf_counter() - t0,
          "iterations": LOOP_ITERS, "loss_ema_at_20": ema20,
          "loss_ema_final": ema, "ema_ratio": ema / ema20,
          "densify_rounds": rounds, "capacity": meta.capacity,
          "capacity_growths": stats["overflows"],
          "tile_overflow": stats["tile_overflow"],
          "dup_overflow": stats["dup_overflow"], "launches": launches})
    return {"launches": launches, "k2_call": k2.calls[0]}


def state_leaves(state) -> dict:
    """{path: tensor} of a (nested) ``TrainState``."""
    out = {}
    for k, v in state._asdict().items():
        if hasattr(v, "_asdict"):
            out.update({f"{k}.{kk}": vv for kk, vv in state_leaves(v).items()})
        else:
            out[k] = v
    return out


def bit_identical(a, b) -> bool:
    """Every tensor of two states equal, with the same dtype and device."""
    la, lb = state_leaves(a), state_leaves(b)
    return la.keys() == lb.keys() and all(
        la[k].dtype == lb[k].dtype and la[k].device == lb[k].device
        and torch.equal(la[k], lb[k]) for k in la)


def train_street_auto(dev, gt_points: torch.Tensor) -> dict:
    """The port's ``tools/train_street`` at full width: the 1M-row street
    scene at its 960x544, 4 views, GT through the self-sized exact path, a
    100k-point start at capacity 262,144, ``exact_extra=-1``.  Two
    invocations of ``main`` of AUTO_SLICE iterations each (the second
    resumes from the first's checkpoint and densifies); between them the
    checkpoint is saved again, reloaded and held bit for bit against the
    in-memory state, and RESUME_STEPS steps from each of the two (same
    ``rng_seed``) must give bit-identical losses.  ``too_far_mask`` over
    the scene points (the GT cloud, ``gt_points``) and the trained rows:
    card against CPU, equal.  Returns {"launches": the phase's launches,
    "calls": one K3 and one K4 call (args, result) at its shapes}."""
    from street_sparse_3dgs_tpu_torch import native
    from street_sparse_3dgs_tpu_torch.config import ModelConfig
    from street_sparse_3dgs_tpu_torch.models import gt_constraint, serialize
    from street_sparse_3dgs_tpu_torch.ops import autosize
    from street_sparse_3dgs_tpu_torch.ops import cuda_blend as cb
    from street_sparse_3dgs_tpu_torch.tools import train_street as ts
    from street_sparse_3dgs_tpu_torch.train.loop import train_loop
    t0 = time.perf_counter()
    run_dir = ROOT / "build" / "smoke" / "train_street"
    shutil.rmtree(run_dir, ignore_errors=True)
    base = ["--dir", str(run_dir), "--n", str(N_ROWS), "--views",
            str(N_VIEWS), "--slice", str(AUTO_SLICE), "--wall", "1e9",
            "--device", str(dev)]
    auto_calls = []
    real_autosize = autosize.autosize_raster

    def timed_autosize(*args, **kw):
        torch.cuda.synchronize()
        a0 = time.perf_counter()
        knobs = real_autosize(*args, **kw)
        torch.cuda.synchronize()
        auto_calls.append({"rows": int(args[0].shape[0]),
                           "ms": (time.perf_counter() - a0) * 1e3,
                           "knobs": knobs._asdict()})
        return knobs

    native.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    autosize.autosize_raster = timed_autosize
    # The tool's progress lines go to stderr: stdout holds the JSON lines.
    try:
        with contextlib.redirect_stdout(sys.stderr):
            r1 = ts.main(base + ["--iters", str(AUTO_SLICE)])
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            path = run_dir / "between.npz"
            serialize.save_checkpoint(path, r1["state"], r1["meta"],
                                      r1["it"])
            save_s = time.perf_counter() - s0
            s0 = time.perf_counter()
            st2, meta2, it2 = serialize.load_checkpoint(path, dev)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - s0
            tool_ckpt = serialize.load_checkpoint(run_dir / "ckpt.npz",
                                                  dev)[0]
            if not (bit_identical(st2, r1["state"]) and meta2 == r1["meta"]
                    and it2 == r1["it"]
                    and bit_identical(tool_ckpt, r1["state"])):
                raise AssertionError("train_street_auto: a reloaded "
                                     "checkpoint differs from the state")
            resumed = []
            for state, meta in ((r1["state"], r1["meta"]), (st2, meta2)):
                # The blend calls of these steps are kept for the kernels
                # line (their shapes are this phase's).
                with Recorder(cb, "blend_exact", first_only=True) as k3, \
                        Recorder(cb, "blend_exact_bwd", first_only=True) as k4:
                    _, _, stats = train_loop(
                        state, meta, r1["batches"], r1["opt"], r1["pipe"],
                        ModelConfig(), cameras_extent=60.0,
                        spatial_lr_scale=60.0, iterations=RESUME_STEPS,
                        densify_enabled=False, rng_seed=r1["it"])
                resumed.append(stats["losses"])
            calls = {"blend_exact": k3.calls[0],
                     "blend_exact_bwd": k4.calls[0]}
            del k3, k4
            if resumed[0] != resumed[1]:
                raise AssertionError(f"train_street_auto: resumed losses "
                                     f"differ: {resumed}")
            del tool_ckpt, st2
            r2 = ts.main(base + ["--iters", str(2 * AUTO_SLICE)])
    finally:
        autosize.autosize_raster = real_autosize
    torch.cuda.synchronize()
    launches = dict(native.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for name in ("slab_gather", "blend_exact", "blend_exact_bwd"):
        if launches[name] == 0:
            raise AssertionError(f"train_street_auto never launched {name}")
    records = r1["records"] + r2["records"]
    if len(records) != 2 or records[1]["it"] != 2 * AUTO_SLICE or \
            not all(math.isfinite(r["loss"]) for r in records) or \
            not all(math.isfinite(p) for p in r1["psnrs"] + r2["psnrs"]):
        raise AssertionError(f"train_street_auto: {records} "
                             f"{r1['psnrs']} {r2['psnrs']}")

    m0 = time.perf_counter()
    gt_np = gt_points.cpu().numpy()
    thr = ModelConfig().constraint_treshold
    state = r2["state"]
    mask = gt_constraint.too_far_mask(
        gt_constraint.build_index(gt_np, thr, device=dev),
        state.params.xyz, state.active)
    mask_cpu = gt_constraint.too_far_mask(
        gt_constraint.build_index(gt_np, thr, device="cpu"),
        state.params.xyz.cpu(), state.active.cpu())
    if not torch.equal(mask.cpu(), mask_cpu):
        raise AssertionError("train_street_auto: too_far_mask differs "
                             "between the card and the CPU")
    emit({"phase": "train_street_auto", "seconds": time.perf_counter() - t0,
          "n": N_ROWS, "width": ts.W, "height": ts.H, "views": N_VIEWS,
          "init_rows": ts.N_INIT, "init_capacity": ts.CAPACITY,
          "slices": records, "autosize_calls": auto_calls,
          "step_ms": [r["wall_per_iter"] * 1e3 for r in records],
          "psnr_after_slice_1": r1["psnrs"], "psnr_final": r2["psnrs"],
          "checkpoint_save_s": save_s, "checkpoint_load_s": load_s,
          "checkpoint_bytes": path.stat().st_size,
          "capacity_at_checkpoint": r1["meta"].capacity,
          "reload_bit_identical": True, "resume_steps": RESUME_STEPS,
          "resume_losses": resumed[0], "resume_losses_bit_identical": True,
          "too_far_rows": int(mask.sum()), "rows_checked": int(mask.numel()),
          "active_rows": int(state.active.sum()),
          "too_far_mask_card_equals_cpu": True,
          "too_far_seconds": time.perf_counter() - m0,
          "peak_memory_bytes": peak, "launches": launches})
    return {"launches": launches, "calls": calls}


# ---- back end: post-optimization, merge, evaluation -------------------------

def partition_report(h, cut, campos) -> dict:
    """The check of tests/test_hierarchy.py::_check_partition, all leaves at
    once (each walks one level up per round): the leaves whose root path
    holds other than exactly one selected node, and of those, the ones
    whose path is monotone in the cut metric.  Where a node's metric
    (size over distance to its box's circumscribed sphere) exceeds its
    parent's, the closed-form cut of ``select_cut`` — the JAX package's and
    the port's alike — selects both an ancestor and a descendant, or
    neither; on a monotone path it is a partition."""
    from street_sparse_3dgs_tpu_torch.hierarchy.structure import _cut_metric
    metric, parent_metric, _ = _cut_metric(h, campos)
    rises = (h.parent >= 0) & (metric > parent_metric)
    parent = h.parent.to(torch.int64)
    sel = cut.selected.to(torch.int64)
    node = torch.nonzero(h.child_count == 0).reshape(-1)
    count = torch.zeros_like(node)
    nonmono = torch.zeros_like(node, dtype=torch.bool)
    while bool((node >= 0).any()):
        alive = node >= 0
        at = torch.clamp(node, min=0)
        count += torch.where(alive, sel[at], torch.zeros_like(at))
        nonmono |= alive & rises[at]
        node = torch.where(alive, parent[at], torch.full_like(at, -1))
    off = count != 1
    return {"leaves": int(node.numel()), "off_partition": int(off.sum()),
            "off_partition_on_monotone_paths": int((off & ~nonmono).sum()),
            "nonmonotone_paths": int(nonmono.sum())}


def merged_cut_matches_chunks(merged, chunks, campos, limit) -> bool:
    """The merged tree's cut is each chunk's own cut, node for node, but at
    the chunk roots, whose parent is now a super node: there it and the
    super nodes follow the cut predicate with the super nodes' metric."""
    from street_sparse_3dgs_tpu_torch.hierarchy.structure import (
        _cut_metric, select_cut)
    got = select_cut(merged, campos, limit).selected
    metric, parent_metric, is_leaf = _cut_metric(merged, campos)
    want = ((metric <= limit) | is_leaf) & (parent_metric > limit)
    offset = 0
    for h in chunks:
        own = select_cut(h, campos, limit).selected
        root = int(torch.nonzero(h.parent < 0)[0])
        keep = torch.ones_like(own)
        keep[root] = False
        want[offset:offset + h.n_nodes] = torch.where(
            keep, own, want[offset:offset + h.n_nodes])
        offset += h.n_nodes
    return bool(torch.equal(got, want))


def post_step_stages(step, state, batch, limit, eye) -> dict:
    """Device-time split of one post-opt step by CUDA events: the cut, the
    compacted gather and lerp, the rasterizer's forward, the loss, the
    backward (``torch.autograd.grad``: K4, the raster's slot->row
    reduction, the gather's backward, the rest), Adam, and what is left of
    the step (the frozen-row masks, the learning rates, gaps between)."""
    from street_sparse_3dgs_tpu_torch.hierarchy import render as hr
    from street_sparse_3dgs_tpu_torch.models import adam
    from street_sparse_3dgs_tpu_torch.ops import cuda_blend as cb
    from street_sparse_3dgs_tpu_torch.train import losses, post
    parts = ("select_cut", "gather_and_lerp", "rasterize", "loss",
             "backward", "adam")
    spans, start, end = event_spans(
        {"select_cut": (post, "select_cut"),
         "gather_and_lerp": (hr, "blend_cut_compact"),
         "rasterize": (hr, "rasterize"),
         "loss": (losses, "photometric"),
         "backward": (torch.autograd, "grad"),
         "blend_exact_bwd": (cb, "blend_exact_bwd"),
         "slot_grads_to_rows": (cb, "slot_grads_to_rows"),
         "gather_backward": (hr, "slot_grads_to_rows"),
         "adam": (adam, "step")},
        lambda: step(state, batch, limit, eye))
    ms = {k: sum(s.elapsed_time(e) for s, e in v) for k, v in spans.items()}
    ms["backward_rest"] = ms["backward"] - ms["blend_exact_bwd"] - \
        ms["slot_grads_to_rows"] - ms["gather_backward"]
    ms["total"] = start.elapsed_time(end)
    ms["other"] = ms["total"] - sum(ms[k] for k in parts)
    return ms


def write_project(root: Path, scene, h, cfg, dev) -> list:
    """A COLMAP project of the street views, written with the port's
    ``data/colmap`` and ``data/png``: PINHOLE cameras, the first POST_POINTS
    rows as points3D.bin (colours from the SH DC band), GT images the tau = 0
    renders of ``h`` through ``render_cut_compact`` (8-bit PNGs), 16-bit
    inverse-depth PNGs of the same renders with depth_params.json (scale the
    view's largest inverse depth), and test.txt naming the last view.
    Returns the GT images [H, W, 3] uint8."""
    import json

    import numpy as np

    from street_sparse_3dgs_tpu_torch.data import colmap, png
    from street_sparse_3dgs_tpu_torch.hierarchy.render import (
        render_cut_compact)
    from street_sparse_3dgs_tpu_torch.hierarchy.structure import (
        pixel_limit, select_cut)
    shutil.rmtree(root, ignore_errors=True)
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    (root / "images").mkdir()
    (root / "depths").mkdir()
    cams, images, params, gts = {}, {}, {}, []
    bg = torch.zeros(3, device=dev)
    for v, cam in enumerate(scene.cameras):
        vm = cam.viewmatrix.cpu().double().numpy()
        focal = cam.width / (2.0 * float(cam.tan_fovx))
        cams[v + 1] = colmap.ColmapCamera(
            v + 1, "PINHOLE", cam.width, cam.height,
            np.array([focal, cam.height / (2.0 * float(cam.tan_fovy)),
                      cam.width / 2.0, cam.height / 2.0]))
        name = f"view{v}.png"
        images[v + 1] = colmap.ColmapImage(
            v + 1, colmap.rotmat2qvec(vm[:3, :3]), vm[:3, 3], v + 1, name,
            np.zeros((0, 2)), np.zeros(0, np.int64))
        lim = pixel_limit(0.0, float(cam.tan_fovx), cam.width)
        with torch.no_grad():
            out = render_cut_compact(h.params, select_cut(h, cam.campos, lim),
                                     h.n_nodes, h.skybox_count, cam, 3, bg,
                                     cfg)
        img = (torch.clamp(out["render"], 0, 1).permute(1, 2, 0) * 255).to(
            torch.uint8).cpu().numpy()
        png.write_png(root / "images" / name, img)
        gts.append(img)
        inv = out["depth"][0].cpu().numpy()
        scale = float(inv.max())
        png.write_png(root / "depths" / f"view{v}.png", np.round(
            np.clip(inv / scale, 0, 1) * 65535).astype(np.uint16))
        params[f"view{v}"] = {"scale": scale, "offset": 0.0}
    xyz = scene.means3d[:POST_POINTS].cpu().double().numpy()
    rgb = torch.clamp(0.5 + 0.28209479177387814 * scene.sh_coeffs[
        :POST_POINTS, 0], 0, 1) * 255
    n = xyz.shape[0]
    colmap.write_model(cams, images, colmap.ColmapPoints(
        xyz=xyz, rgb=rgb.to(torch.uint8).cpu().numpy(), error=np.zeros(n),
        ids=np.arange(n, dtype=np.int64)), sparse)
    (sparse / "depth_params.json").write_text(json.dumps(params))
    (sparse / "test.txt").write_text(f"view{len(scene.cameras) - 1}.png\n")
    return gts


def post_opt(dev, scene, hier_path: Path, pipe) -> dict:
    """Stage 4 of the pipeline on the card at full width: a COLMAP project
    of the street views (``write_project``, GT from phase hierarchy's
    saved tree) loaded back with ``load_scene_info`` and ``CameraStream``
    (view matrices to 1e-5, GT images exactly); the rows split at the median
    x into two chunks, a hierarchy built and saved for each; on chunk 0 at
    view 0, tau 3, the compacted render against the mask form (images at
    IMG_ATOL with FLIP_SHARE, grads within COMPACT_GRAD_BAR * max|g| +
    COMPACT_GRAD_RTOL * |g|); then ``CompactPostDriver`` on chunk 0 in the
    production exact counts config, POST_STEPS steps over the training
    views, limits from ``random_limit(random.Random(0))``, starting at an
    eighth of ``default_post_capacity`` (launches counted), which must grow
    and redo; a second driver at the grown capacity must end bit for bit
    where the first did; anchor rows (the first N_ANCHORS when the build
    made none) unmoved and the rest moved; the photometric loss at tau 3
    and 6 over the training views lower after than before; the optimised
    hierarchy saved and reloaded equal; ``tools/post_scaling``'s
    measurement.  Returns {"launches", "calls" (one K3 and one K4 call at
    this phase's shapes), "chunks" (optimised chunk 0, chunk 1),
    "project"}."""
    import random

    import numpy as np

    from street_sparse_3dgs_tpu_torch import native
    from street_sparse_3dgs_tpu_torch.config import (ModelConfig,
                                                     OptimizationConfig)
    from street_sparse_3dgs_tpu_torch.data.scene import (CameraStream,
                                                         load_scene_info)
    from street_sparse_3dgs_tpu_torch.hierarchy.build import build_hierarchy
    from street_sparse_3dgs_tpu_torch.hierarchy.io import (load_hierarchy,
                                                           save_hierarchy)
    from street_sparse_3dgs_tpu_torch.hierarchy.render import (
        render_cut, render_cut_compacted)
    from street_sparse_3dgs_tpu_torch.hierarchy.structure import (
        pixel_limit, select_cut)
    from street_sparse_3dgs_tpu_torch.models.gaussians import GaussianParams
    from street_sparse_3dgs_tpu_torch.ops import binning
    from street_sparse_3dgs_tpu_torch.ops import cuda_blend as cb
    from street_sparse_3dgs_tpu_torch.tools import post_scaling
    from street_sparse_3dgs_tpu_torch.train.post import (
        CompactPostDriver, default_post_capacity, init_post_state,
        make_post_step, random_limit)
    from street_sparse_3dgs_tpu_torch.train.step import raster_config
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    root = ROOT / "build" / "smoke" / "post_project"
    rcfg = raster_config(pipe)
    bg = torch.zeros(3, device=dev)
    timing = {}

    # The project, written and loaded back.
    h_full = load_hierarchy(hier_path, device=dev)
    gts = write_project(root, scene, h_full, rcfg, dev)
    del h_full
    timing["write_project_s"] = time.perf_counter() - t0
    s0 = time.perf_counter()
    info = load_scene_info(root, ModelConfig(eval=True, depths="depths"))
    loaded = {}
    for infos in (info.train_cameras, info.test_cameras):
        stream = CameraStream(infos, resolution=1, shuffle=False, device=dev)
        try:
            for c, b in zip(infos, stream):
                loaded[int(c.image_name[4:-4])] = b
        finally:
            stream.close()
    timing["load_project_s"] = time.perf_counter() - s0
    if sorted(loaded) != list(range(len(scene.cameras))) or \
            len(info.test_cameras) != 1:
        raise AssertionError(f"post_opt: loaded views {sorted(loaded)}, "
                             f"{len(info.test_cameras)} test")
    view_err = []
    for v, cam in enumerate(scene.cameras):
        b = loaded[v]
        view_err.append(float((b.camera.viewmatrix - cam.viewmatrix)
                              .abs().max()))
        # The loader's arithmetic, on the host (a CUDA division by a scalar
        # multiplies by its reciprocal, which rounds differently).
        want = torch.from_numpy(gts[v].astype(np.float32).transpose(2, 0, 1)
                                / 255.0)
        if not torch.equal(b.gt_image.cpu(), want):
            raise AssertionError(f"post_opt: view {v}'s GT image differs "
                                 "from the written PNG")
        if not bool(b.depth_reliable):
            raise AssertionError(f"post_opt: view {v} lost its depth")
    if max(view_err) > 1e-5:
        raise AssertionError(f"post_opt: view matrices off by {view_err} "
                             "(bar 1e-5)")
    train_b = [loaded[v] for v in range(len(scene.cameras) - 1)]

    # Two chunks at the median x, a hierarchy each.
    s0 = time.perf_counter()
    x = scene.means3d[:, 0]
    side = x >= torch.median(x)
    chunks, sizes = [], []
    for c, rows in enumerate((~side, side)):
        idx = torch.nonzero(rows).reshape(-1)
        sizes.append(int(idx.numel()))
        p = GaussianParams(
            xyz=scene.means3d[idx], features_dc=scene.sh_coeffs[idx, :1],
            features_rest=scene.sh_coeffs[idx, 1:],
            log_scales=torch.log(scene.scales[idx]), quats=scene.quats[idx],
            opacity_raw=scene.opacities[idx, None])
        h_c = build_hierarchy(p, opacity_activation="abs", device=dev)
        save_hierarchy(root / f"chunk{c}.hier.npz", h_c)
        chunks.append(h_c)
    timing["build_chunks_s"] = time.perf_counter() - s0
    h0 = chunks[0]
    anchors_marked = not bool(h0.anchors.any()) and h0.skybox_count == 0
    if anchors_marked:
        anchors = torch.zeros_like(h0.anchors)
        anchors[:N_ANCHORS] = True
        h0 = h0._replace(anchors=anchors)

    # The two render forms on chunk 0, view 0, tau 3.
    cam = scene.cameras[0]
    cut = select_cut(h0, cam.campos, pixel_limit(3.0, float(cam.tan_fovx),
                                                 cam.width))
    n_sel = int(cut.selected.sum())
    cap = 1 << (n_sel - 1).bit_length()

    def form(compact: bool):
        params = GaussianParams(*(p.detach().requires_grad_(True)
                                  for p in h0.params))
        if compact:
            out = render_cut_compacted(params, cut, h0.n_nodes,
                                       h0.skybox_count, cap, cam, 3, bg, rcfg)
        else:
            out = render_cut(params, cut, h0.n_nodes, h0.skybox_count, cam,
                             3, bg, rcfg)
        loss = out["render"].pow(2).mean() + 0.3 * out["depth"].pow(2).mean()
        grads = torch.autograd.grad(loss, params)
        return ({k: out[k].detach() for k in ("render", "depth",
                                              "tile_overflow")},
                float(loss), grads)

    (out_m, loss_m, g_m), (out_c, loss_c, g_c) = form(False), form(True)
    img_m = torch.cat([out_m["render"], out_m["depth"]])
    img_c = torch.cat([out_c["render"], out_c["depth"]])
    over = int(((img_c - img_m).abs().amax(dim=0) > IMG_ATOL).sum())
    if over > FLIP_SHARE * cam.height * cam.width or \
            int(out_m["tile_overflow"]) or int(out_c["tile_overflow"]):
        raise AssertionError(f"post_opt: compacted render {over} pixels over "
                             f"{IMG_ATOL}, tile_overflow "
                             f"{int(out_m['tile_overflow'])} / "
                             f"{int(out_c['tile_overflow'])}")
    forms = {"cut": n_sel, "capacity": cap, "pixels_over_atol": over,
             "max_abs_err": float((img_c - img_m).abs().max()),
             "loss_mask": loss_m, "loss_compact": loss_c, "grads": {}}
    for name, a, b in zip(GaussianParams._fields, g_m, g_c):
        scale = float(a.abs().max())
        diff = (b - a).abs()
        outside = int((diff > COMPACT_GRAD_BAR * scale
                       + COMPACT_GRAD_RTOL * a.abs()).sum())
        forms["grads"][name] = {"max_scaled_err": float(diff.max()) / scale,
                                "outside_bar": outside}
        if outside or scale == 0.0:
            raise AssertionError(f"post_opt: compacted grad {name}: "
                                 f"{outside} elements outside the bar, "
                                 f"max|g| {scale}")
    del g_m, g_c, out_m, out_c, img_m, img_c

    # The driver (main path, counted), then a second one at the grown
    # capacity.
    opt = OptimizationConfig()
    eye = torch.eye(3, 4, device=dev)
    start_cap = default_post_capacity(
        h0, [b.camera.campos.cpu().numpy() for b in train_b]) // 8

    def drive(capacity):
        d = CompactPostDriver(h0, opt, pipe, capacity, skybox_locked=True,
                              use_trained_exp=True)
        rng = random.Random(0)
        rec = {"step_ms": [], "capacity": [], "cut": [], "loss": []}
        for i in range(POST_STEPS):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            aux = d.step(train_b[i % len(train_b)], random_limit(rng), eye)
            torch.cuda.synchronize()
            rec["step_ms"].append((time.perf_counter() - s0) * 1e3)
            rec["capacity"].append(d.capacity)
            if aux is not None:
                rec["cut"].append(int(aux["n_selected"]))
                rec["loss"].append(float(aux["loss"]))
        return d, d.finish(), rec

    native.reset_launches()
    d1, state1, rec1 = drive(start_cap)
    torch.cuda.synchronize()
    launches = dict(native.LAUNCHES)
    for name in ("slab_gather", "blend_exact", "blend_exact_bwd"):
        if launches[name] == 0:
            raise AssertionError(f"post_opt never launched {name}")
    if d1.redos == 0 or d1.capacity <= start_cap:
        raise AssertionError(f"post_opt: the driver did not grow "
                             f"({start_cap} -> {d1.capacity}, {d1.redos} "
                             "redos)")
    d2, state2, _ = drive(d1.capacity)
    if d2.redos or not all(torch.equal(a, b) for a, b in zip(
            state_leaves(state1).values(), state_leaves(state2).values())):
        raise AssertionError("post_opt: the driver's redo differs from a run "
                             f"started at capacity {d1.capacity}")
    del d2, state2
    frozen = d1._step.frozen_rows
    for name, a, b in zip(GaussianParams._fields, h0.params, state1.params):
        if not torch.equal(a[frozen], b[frozen]):
            raise AssertionError(f"post_opt: frozen rows of {name} moved")
    moved = {name: int((a[~frozen] != b[~frozen]).reshape(
        int((~frozen).sum()), -1).any(dim=1).sum())
        for name, a, b in zip(GaussianParams._fields, h0.params,
                              state1.params)}
    if not moved["xyz"] or not moved["features_dc"]:
        raise AssertionError(f"post_opt: unfrozen rows did not move {moved}")

    # The photometric loss at fixed limits, before and after (mask form).
    probe = make_post_step(h0, opt, pipe, skybox_locked=True,
                           use_trained_exp=True)

    def photometric(params):
        out = {}
        for tau in (3.0, 6.0):
            for v, b in enumerate(train_b):
                c = select_cut(h0, b.camera.campos, pixel_limit(
                    tau, float(b.camera.tan_fovx), b.camera.width))
                with torch.no_grad():
                    out[f"view{v} tau{tau:g}"] = float(
                        probe.loss(params, b, c, eye)[0])
        return out

    before, after = photometric(h0.params), photometric(state1.params)
    if not statistics.mean(after.values()) < statistics.mean(
            before.values()):
        raise AssertionError(f"post_opt: photometric loss did not fall: "
                             f"{before} -> {after}")

    # K3 and K4 at this phase's shapes: one step at the grown capacity.
    step = make_post_step(h0, opt, pipe, skybox_locked=True,
                          use_trained_exp=True, compact_capacity=d1.capacity)
    with Recorder(cb, "blend_exact", first_only=True) as k3, \
            Recorder(cb, "blend_exact_bwd", first_only=True) as k4, \
            Recorder(binning, "slab_gather", first_only=True) as k5:
        step(init_post_state(h0), train_b[0], random_limit(random.Random(0)),
             eye)
    calls = {"blend_exact": k3.calls[0], "blend_exact_bwd": k4.calls[0],
             "slab_gather": k5.calls[0]}
    lim = random_limit(random.Random(0))
    stages = post_step_stages(step, state1, train_b[0], lim, eye)
    prof = device_profile(lambda: step(state1, train_b[0], lim, eye))
    del step, probe

    s0 = time.perf_counter()
    h_opt = h0._replace(params=state1.params)
    opt_path = root / "hierarchy.hier_opt.npz"
    save_hierarchy(opt_path, h_opt)
    back = load_hierarchy(opt_path, device=dev)
    if not (back.skybox_count == h_opt.skybox_count and all(
            torch.equal(a, b) for a, b in zip(
                list(back.params) + list(back[1:-1]),
                list(h_opt.params) + list(h_opt[1:-1])))):
        raise AssertionError("post_opt: hier_opt reloaded differs")
    timing["save_load_hier_opt_s"] = time.perf_counter() - s0
    peak = torch.cuda.max_memory_allocated()
    del state1, back

    s0 = time.perf_counter()
    scaling = post_scaling.measure(dev)
    timing["post_scaling_s"] = time.perf_counter() - s0
    torch.cuda.synchronize()
    emit({"phase": "post_opt", "seconds": time.perf_counter() - t0,
          "views": len(scene.cameras), "width": WIDTH, "height": HEIGHT,
          "points3d": POST_POINTS, "view_matrix_max_err": max(view_err),
          "gt_images_equal": True, "chunk_rows": sizes,
          "chunk_nodes": [h.n_nodes for h in chunks],
          "anchors_marked": N_ANCHORS if anchors_marked else 0,
          "frozen_rows": int(frozen.sum()),
          "config": {k: v for k, v in vars(pipe).items()},
          "forms_at_view0_tau3": forms,
          "steps": POST_STEPS, "train_views": len(train_b),
          "start_capacity": start_cap, "final_capacity": d1.capacity,
          "capacity_path": rec1["capacity"], "redos": d1.redos,
          "redo_bit_identical": True, "cut_sizes": rec1["cut"],
          "step_ms": rec1["step_ms"],
          "step_ms_median": statistics.median(rec1["step_ms"][WARMUP_STEPS:]),
          "losses": rec1["loss"], "rows_moved": moved,
          "photometric_before": before, "photometric_after": after,
          "stage_ms": stages, **prof,
          "peak_memory_bytes": peak, "launches": launches,
          "post_scaling": scaling, **timing})
    return {"launches": launches, "calls": calls, "chunks": [h_opt, chunks[1]],
            "project": root, "chunk_nodes": [h.n_nodes for h in chunks]}


def merge_eval(dev, chunks, project: Path, pipe, campos) -> dict:
    """Stage 5 and the eval on the card: ``merge_hierarchies`` of the
    optimised chunk 0 and chunk 1 (one node more than the chunks, one root;
    the cut from ``campos`` at limits 0, 0.05 and 1e9 each chunk's own cut
    and, by ``partition_report``, a partition at 0 and 1e9 and at 0.05 on
    every path where the metric is monotone, with no leaf off the
    partition but those off it in the chunks' own trees; a ``.hier.npz``
    round trip),
    then ``render_hierarchy_eval`` of the merged tree on the test view of
    phase post_opt's project at TAUS with LPIPS (launches
    counted; TF32 switched on before it and off after; every metric finite,
    tau 0's PSNR at least PSNR_TAU0_MIN, tau 15's no higher than tau 0's)
    and one ``render_position`` call at tau 0, shifted, its PNGs written.
    Returns {"launches", "calls"}: each tau's K3 and K5 (args, result), for
    the kernels phase to hold against the plain versions."""
    import numpy as np

    from street_sparse_3dgs_tpu_torch import native
    from street_sparse_3dgs_tpu_torch.config import ModelConfig
    from street_sparse_3dgs_tpu_torch.data import png
    from street_sparse_3dgs_tpu_torch.data.scene import load_scene_info
    from street_sparse_3dgs_tpu_torch.eval.render_hier import (
        render_hierarchy_eval)
    from street_sparse_3dgs_tpu_torch.eval.render_position import (
        group_cameras_by_center, render_position)
    from street_sparse_3dgs_tpu_torch.hierarchy.io import (load_hierarchy,
                                                           save_hierarchy)
    from street_sparse_3dgs_tpu_torch.hierarchy.merge import (
        merge_hierarchies)
    from street_sparse_3dgs_tpu_torch.hierarchy.structure import select_cut
    from street_sparse_3dgs_tpu_torch.ops import binning
    from street_sparse_3dgs_tpu_torch.ops import cuda_blend as cb
    t0 = time.perf_counter()
    out_root = ROOT / "build" / "smoke" / "merge_eval"
    shutil.rmtree(out_root, ignore_errors=True)
    merged = merge_hierarchies(chunks, device=dev)
    merge_s = time.perf_counter() - t0
    n_a, n_b = (h.n_nodes for h in chunks)
    roots = int((merged.parent < 0).sum())
    if merged.n_nodes != n_a + n_b + 1 or roots != 1:
        raise AssertionError(f"merge_eval: {merged.n_nodes} nodes from "
                             f"{n_a} + {n_b}, {roots} roots")
    partition = {}
    for lim in (0.0, 0.05, 1e9):
        rep = partition_report(merged, select_cut(merged, campos, lim),
                               campos)
        rep["chunks"] = [partition_report(h, select_cut(h, campos, lim),
                                          campos)["off_partition"]
                         for h in chunks]
        partition[f"{lim:g}"] = rep
        # A partition at the extremes; in between, wherever the metric is
        # monotone along the path (PERF.md §6), the chunks' cuts kept node
        # for node, and no leaf off the partition but the chunks' own.
        if (rep["off_partition"] if lim in (0.0, 1e9)
                else rep["off_partition_on_monotone_paths"]) or \
                rep["off_partition"] != sum(rep["chunks"]) or \
                not merged_cut_matches_chunks(merged, chunks, campos, lim):
            raise AssertionError(f"merge_eval: the cut at limit {lim}: "
                                 f"{rep}")
    s0 = time.perf_counter()
    path = out_root / "merged.hier.npz"
    save_hierarchy(path, merged)
    back = load_hierarchy(path, device=dev)
    if not (back.skybox_count == merged.skybox_count and all(
            torch.equal(a, b) for a, b in zip(
                list(back.params) + list(back[1:-1]),
                list(merged.params) + list(merged[1:-1])))):
        raise AssertionError("merge_eval: merged.hier.npz reloaded differs")
    io_s = time.perf_counter() - s0
    del back

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    cfg = ModelConfig(eval=True, depths="depths", resolution=1)
    native.reset_launches()
    s0 = time.perf_counter()
    # The eval's per-tau lines go to stderr: stdout holds the JSON lines.
    # Every tau's K3 and K5 call is kept for the kernels phase.
    with contextlib.redirect_stdout(sys.stderr), \
            Recorder(cb, "blend_exact") as k3, \
            Recorder(binning, "slab_gather") as k5:
        res = render_hierarchy_eval(merged, str(project), cfg, pipe,
                                    taus=TAUS, out_dir=out_root,
                                    with_lpips=True, with_breakdowns=True)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - s0
    launches = dict(native.LAUNCHES)
    if torch.backends.cudnn.allow_tf32 or \
            torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("merge_eval: the eval left TF32 on")
    for name in ("slab_gather", "blend_exact"):
        if launches[name] == 0:
            raise AssertionError(f"merge_eval: the eval never launched "
                                 f"{name}")
    values = [v for r in res.values() for k, v in r.items()
              if isinstance(v, float)]
    values += [x for r in res.values() for band in r["bands"].values()
               for x in band.values()]
    if len(values) < 5 * len(TAUS) or \
            not all(math.isfinite(v) for v in values) or \
            any(r.get("lpips_weights") not in ("random", "calibrated")
                for r in res.values()):
        raise AssertionError(f"merge_eval: metrics {res}")
    if not (res[0.0]["psnr"] >= PSNR_TAU0_MIN
            and res[15.0]["psnr"] <= res[0.0]["psnr"]):
        raise AssertionError(f"merge_eval: PSNR tau 0 {res[0.0]['psnr']} "
                             f"(bar {PSNR_TAU0_MIN}), tau 15 "
                             f"{res[15.0]['psnr']}")

    s0 = time.perf_counter()
    info = load_scene_info(project, ModelConfig(eval=True))
    centre = next(iter(sorted(group_cameras_by_center(
        info.test_cameras).items())))[1][0][1]
    with contextlib.redirect_stdout(sys.stderr):
        written = render_position(merged, str(project), float(centre[0])
                                  + POSITION_SHIFT, float(centre[1]),
                                  out_dir=out_root / "position",
                                  model_cfg=ModelConfig(eval=True),
                                  pipe=pipe, tau=0.0, resolution=1)
    position_s = time.perf_counter() - s0
    shifted = [png.read_png(p) for p in written]
    if not written or any(a.shape != (HEIGHT, WIDTH, 3) or
                          float(np.std(a)) == 0.0 for a in shifted):
        raise AssertionError(f"merge_eval: render_position wrote {written}")
    emit({"phase": "merge_eval", "seconds": time.perf_counter() - t0,
          "merge_seconds": merge_s, "save_load_seconds": io_s,
          "eval_seconds": eval_s, "position_seconds": position_s,
          "nodes": merged.n_nodes, "chunk_nodes": [n_a, n_b],
          "partition": partition, "taus": list(TAUS),
          "eval": {f"{tau:g}": r for tau, r in res.items()},
          "tf32_off_after_eval": True,
          "position_files": [p.name for p in written],
          "position_shift_m": POSITION_SHIFT,
          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches})
    return {"launches": launches,
            "calls": {"blend_exact": k3.calls, "slab_gather": k5.calls}}


# ---- phase full_train: the CLI over a two-chunk project -------------------

def wire_matrices(cam) -> tuple:
    """The SIBR viewer's row-vector view and view-projection matrices of a
    renderer camera (``network_gui``'s y/z column flip undone)."""
    out = []
    for m in (cam.viewmatrix, cam.projmatrix):
        m = m.detach().cpu().double().clone()
        m[1:3] = -m[1:3]
        out.append(m.T.float().numpy())
    return tuple(out)


def viewer_client(port: int, cam, frames: int, result: dict) -> None:
    """A SIBR remote-viewer client: connects to ``port`` (retrying while
    the trainer loads its scene), asks for ``frames`` RGB frames of ``cam``
    one after another (the reply latency of each on the host clock), reads
    each frame and the verify string, then disconnects."""
    import numpy as np
    import socket
    view, proj = wire_matrices(cam)
    fovx = 2 * math.atan(float(cam.tan_fovx))
    fovy = 2 * math.atan(float(cam.tan_fovy))
    body = json.dumps({
        "resolution_x": cam.width, "resolution_y": cam.height,
        "train": True, "fov_y": fovy, "fov_x": fovx, "z_near": 0.01,
        "z_far": 100.0, "shs_python": False, "rot_scale_python": False,
        "keep_alive": True, "scaling_modifier": 1.0,
        "view_matrix": view.flatten().tolist(),
        "view_projection_matrix": proj.flatten().tolist()}).encode()
    msg = len(body).to_bytes(4, "little") + body
    deadline = time.monotonic() + 600
    sock = None
    while sock is None and time.monotonic() < deadline:
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=5)
        except OSError:
            time.sleep(0.05)
    if sock is None:
        result["error"] = "no listener"
        return

    def recv(n):
        buf = bytearray()
        while len(buf) < n:
            part = sock.recv(n - len(buf))
            if not part:
                raise ConnectionError("viewer closed")
            buf += part
        return bytes(buf)

    result["frames"], result["latency_ms"] = [], []
    try:
        sock.settimeout(300)
        for _ in range(frames):
            t0 = time.perf_counter()
            sock.sendall(msg)
            img = np.frombuffer(recv(cam.height * cam.width * 3), np.uint8)
            n = int.from_bytes(recv(4), "little")
            result["verify"] = recv(n).decode()
            result["latency_ms"].append((time.perf_counter() - t0) * 1e3)
            result["frames"].append(img.reshape(cam.height, cam.width, 3))
    except OSError as exc:            # ConnectionError included
        result["error"] = repr(exc)
    finally:
        sock.close()


class _OneRequest:
    """Stands in for ``NetworkGUI`` when ``ViewerHook`` is called outside a
    training loop: its poll renders one request and keeps the frame."""

    def __init__(self, req):
        self.req, self.frame = req, None

    def poll(self, render_fn, source_path, training_done=False):
        self.frame = render_fn(self.req)
        return True


def write_chunked_project(root: Path, scene, post_project: Path) -> dict:
    """The two-chunk project of ``pipeline.full_train``: the cameras
    (``cameras.bin``, ``images.bin``; data/colmap), the GT PNGs, the 16-bit
    inverse depths with depth_params.json (data/png) and test.txt of phase
    post_opt's project, copied; ``rectified/masks`` (``<image>.png``, 255
    where the GT has content and 0 over its empty sky, which no row of the
    scene covers, so that the training loss does not score the random
    background there); ``aligned/sparse/0`` with the street
    scene's N_ROWS rows as points3D.ply (colours from the SH DC band), and
    ``chunks/{0_0,1_0}`` with the rows on either side of the median x,
    each with center.txt and extent.txt (the middle and size of its rows'
    box).  Returns the chunks' row counts."""
    import numpy as np

    from street_sparse_3dgs_tpu_torch.data import png
    from street_sparse_3dgs_tpu_torch.data.ply import store_point_cloud
    shutil.rmtree(root, ignore_errors=True)
    rect = root / "rectified"
    rect.mkdir(parents=True)
    shutil.copytree(post_project / "images", rect / "images")
    shutil.copytree(post_project / "depths", rect / "depths")
    (rect / "masks").mkdir()
    for f in sorted((rect / "images").glob("*.png")):
        gt = np.asarray(png.read_image(f))
        png.write_png(rect / "masks" / f"{f.name}.png",
                      np.where(gt.max(axis=-1) > 0, 255, 0).astype(np.uint8))
    xyz = scene.means3d.cpu().double().numpy()
    rgb = (torch.clamp(0.5 + 0.28209479177387814 * scene.sh_coeffs[:, 0],
                       0, 1) * 255).to(torch.uint8).cpu().numpy()
    x = scene.means3d[:, 0]
    side = (x >= torch.median(x)).cpu().numpy()
    calib = root / "camera_calibration"
    sets = {calib / "aligned": slice(None),
            calib / "chunks" / "0_0": ~side, calib / "chunks" / "1_0": side}
    rows = {}
    for d, sel in sets.items():
        sparse = d / "sparse" / "0"
        sparse.mkdir(parents=True)
        for f in ("cameras.bin", "images.bin", "depth_params.json",
                  "test.txt"):
            shutil.copy(post_project / "sparse" / "0" / f, sparse / f)
        store_point_cloud(sparse / "points3D.ply", xyz[sel], rgb[sel])
        rows[d.name] = int(xyz[sel].shape[0])
        if d.parent.name == "chunks":
            lo, hi = xyz[sel].min(axis=0), xyz[sel].max(axis=0)
            (d / "center.txt").write_text(
                " ".join(f"{v:.6f}" for v in (lo + hi) / 2) + "\n")
            (d / "extent.txt").write_text(
                " ".join(f"{v:.6f}" for v in hi - lo) + "\n")
    return rows


def held_against_plain(stage: str, key: str, args, out) -> dict:
    """One recorded K3, K4 or K5 call of a full_train stage against its
    plain version: K3 at the image bar with the flip share, K4 at GRAD_BAR
    x max|g| per channel, K5 exactly.  Raises past the bar."""
    from street_sparse_3dgs_tpu_torch.ops import binning
    from street_sparse_3dgs_tpu_torch.ops import cuda_blend as cb
    row = {"stage": stage, "tiles": args[1].shape[0]
           if key == "slab_gather" else args[3].shape[0]}
    if key == "blend_exact":
        cmp = compare_blend(out, cb.blend_exact_plain(*args))
        check_blend(f"K3 at full_train {stage}", cmp, strict=False)
        row.update(max_abs_err=cmp["max_abs_err"], flips=cmp["flips"],
                   pixels_over_atol=cmp["pixels_over_atol"])
    elif key == "blend_exact_bwd":
        cmp = compare_grads(f"K4 at full_train {stage}", out,
                            cb.blend_exact_bwd_plain(*args), 2)
        row.update(max_abs_err=cmp["max_abs_err"],
                   max_scaled_err=cmp["max_scaled_err"])
    else:
        row["max_abs_err"] = float((out - binning.slab_gather_plain(
            *args)).abs().max())
        if row["max_abs_err"]:
            raise AssertionError(f"K5 at full_train {stage}: table differs "
                                 "from plain")
    return row


@contextlib.contextmanager
def stage_probes(stages: dict, keep: tuple = ()):
    """While the block runs, every ``stage_timer`` stage (and every
    ``manual`` stage the caller opens with ``stages["open"](name)``) gets:
    its launches (a difference of ``native.LAUNCHES``), the first K3, K4
    and K5 call (``Recorder(first_only=True)``) held against its plain
    version when the stage ends (``held_against_plain``; the calls
    themselves kept only for the stages in ``keep``, so that the device
    holds one stage's inputs at a time), the ms of each synchronised train
    or post step (host clock), the post steps' summed ``tile_overflow``,
    and the train loop's stats, meta and the device memory peak.
    ``stages`` maps each stage's name to that record."""
    from street_sparse_3dgs_tpu_torch import native, utils
    from street_sparse_3dgs_tpu_torch.ops import binning
    from street_sparse_3dgs_tpu_torch.ops import cuda_blend as cb
    from street_sparse_3dgs_tpu_torch.pipeline import full_train as ft
    from street_sparse_3dgs_tpu_torch.train import post, step
    current = []

    @contextlib.contextmanager
    def probe(name):
        rec = stages.setdefault(name, {"step_ms": [], "loops": []})
        before = dict(native.LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        current.append(rec)
        try:
            with Recorder(cb, "blend_exact", first_only=True) as k3, \
                    Recorder(cb, "blend_exact_bwd", first_only=True) as k4, \
                    Recorder(binning, "slab_gather", first_only=True) as k5:
                yield
            torch.cuda.synchronize()
        finally:
            current.pop()
        rec["launches"] = {k: native.LAUNCHES[k] - before[k]
                           for k in before if native.LAUNCHES[k] > before[k]}
        rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        calls = {r.name: r.calls[0] for r in (k3, k4, k5) if r.calls}
        del k3, k4, k5
        s0 = time.perf_counter()
        rec["checks"] = {key: held_against_plain(name, key, *call)
                         for key, call in calls.items()}
        rec["check_seconds"] = time.perf_counter() - s0
        if name in keep:
            rec["calls"] = calls

    real_timer = utils.stage_timer

    @contextlib.contextmanager
    def timer(name, *a, **k):
        with probe(name), real_timer(name, *a, **k):
            yield

    def timed(fn):
        def wrapped(self, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, *a, **k)
            torch.cuda.synchronize()
            if current:
                current[-1]["step_ms"].append((time.perf_counter() - t0)
                                              * 1e3)
            return out
        return wrapped

    real_loop, real_cut = ft.train_loop, post.render_cut_compacted

    def loop(state, meta, *a, **k):
        out = real_loop(state, meta, *a, **k)
        if current:
            current[-1]["loops"].append({"start_capacity": meta.capacity,
                                         "meta": out[1], "stats": out[2]})
        return out

    def cut(*a, **k):
        out = real_cut(*a, **k)
        if current:
            rec = current[-1]
            rec["post_tile_overflow"] = rec.get(
                "post_tile_overflow", 0) + out["tile_overflow"]
        return out

    saved = [(step.TrainStep, "__call__", step.TrainStep.__call__),
             (post.PostStep, "__call__", post.PostStep.__call__)]
    utils.stage_timer, ft.train_loop = timer, loop
    post.render_cut_compacted = cut
    for owner, name, fn in saved:
        setattr(owner, name, timed(fn))
    stages["open"] = probe
    try:
        yield stages
    finally:
        utils.stage_timer, ft.train_loop = real_timer, real_loop
        post.render_cut_compacted = real_cut
        for owner, name, fn in saved:
            setattr(owner, name, fn)
        stages.pop("open")


def ft_budgets(dev, scene, pipe):
    """``pipe`` (the production exact counts config) with the emission
    ladder and window budget that ``ops/autosize`` measures for the coarse
    stage's initial rows (``create_from_pcd`` on the street scene's rows:
    kNN scales, opacity 0.1) over the 4 views, with FT_MARGIN headroom, and
    the autosizer's report."""
    import dataclasses

    from street_sparse_3dgs_tpu_torch.models.gaussians import (
        activate_opacity, activate_scales, create_from_pcd, sh_coeffs)
    from street_sparse_3dgs_tpu_torch.ops.autosize import autosize_raster
    t0 = time.perf_counter()
    rows = scene.means3d
    params, active, meta = create_from_pcd(
        rows, torch.full_like(rows, 0.5), sh_degree=3,
        capacity=rows.shape[0])
    knobs = autosize_raster(
        params.xyz, activate_scales(params), params.quats,
        activate_opacity(params, meta), sh_coeffs(params), scene.cameras,
        3, HEIGHT, WIDTH, pipe.tile_capacity, max_dup=0, margin=FT_MARGIN,
        active_mask=active, scan_cap_max=256)
    torch.cuda.synchronize()
    del params, active
    report = {**knobs._asdict(), "margin": FT_MARGIN,
              "seconds": time.perf_counter() - t0}
    return dataclasses.replace(
        pipe, max_dup=knobs.max_dup, dup_overscan=knobs.dup_overscan,
        dup_tails=knobs.dup_tails, exact_extra=knobs.exact_extra), report


def full_train_phase(dev, scene, post_project: Path, pipe) -> dict:
    """The five stages through the command line at full width: a two-chunk
    project (``write_chunked_project``: 4 street views at 1920x1088, view 3
    held out, the street scene's N_ROWS rows as the aligned cloud, each
    chunk its half) and ``cli.main(["full-train", ...])`` in the production
    exact counts config (``--raster_method pallas``, as phase post_opt,
    with the budgets of ``ft_budgets`` and FT_SKYBOX skybox rows),
    ``--resolution 1 --eval --seed 0 --disable_viewer --skip_if_exists``,
    depth cut to FT_COARSE / FT_CHUNK (densifying at FT_DENSIFY) /
    FT_POST steps by wrapping ``pipeline.full_train.full_train`` (the
    command takes no per-stage iteration flags).  Then
    ``render-hierarchy`` of ``merged.hier.npz`` on the held-out view at
    TAUS with LPIPS; a second ``full-train`` that must skip every stage and
    return the merged tree; one ``python -m
    street_sparse_3dgs_tpu_torch.cli render-hierarchy`` in a subprocess;
    ``train-single`` on chunk 0 for FT_VIEWER_STEPS steps with the viewer on
    (a free port) while a client thread asks for FT_FRAMES 1920x1088 frames;
    ``ViewerHook`` on its saved state against the plain render.  Fails
    unless every artifact exists, the timing log names the eight stages,
    each training stage's loss is finite and falls, the production steps
    show no tile overflow or skipped update (unless a budget grew), the
    merged tree has one root and the chunks' nodes plus one, tau 0's PSNR
    is finite and above FT_PSNR_MIN, tau 15's at most tau 0's, the rerun
    skips everything, the client got its frames, K3, K4 and K5 ran in
    every training and post stage, and each stage's first K3, K4 and K5
    call agrees with its plain version (``stage_probes``).  Returns
    {"launches", "checks" (those comparisons by stage), "timed" (the first
    calls of stage FT_TIMED, which phase 15 times)}."""
    import dataclasses
    import io
    import subprocess

    import numpy as np

    from street_sparse_3dgs_tpu_torch import cli, native
    from street_sparse_3dgs_tpu_torch.hierarchy.structure import (
        pixel_limit, select_cut)
    from street_sparse_3dgs_tpu_torch.models.gaussians import (
        GaussianMeta, activate_opacity, activate_scales, sh_coeffs)
    from street_sparse_3dgs_tpu_torch.models.serialize import load_scene_ply
    from street_sparse_3dgs_tpu_torch.pipeline import full_train as ft
    from street_sparse_3dgs_tpu_torch.train.step import (init_state,
                                                         raster_config)
    from street_sparse_3dgs_tpu_torch.viewer.hook import ViewerHook
    from street_sparse_3dgs_tpu_torch.viewer.network_gui import (
        ViewerRequest)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    root = ROOT / "build" / "smoke" / "ft_project"
    rows = write_chunked_project(root, scene, post_project)
    write_s = time.perf_counter() - t0
    paths = ft.ProjectPaths(root)
    pipe, budgets = ft_budgets(dev, scene, pipe)
    tails = ",".join(f"{b}:{w}" for b, w in pipe.dup_tails)
    flags = ["--raster_method", "pallas", "--max_dup", str(pipe.max_dup),
             "--tile_capacity", str(pipe.tile_capacity), "--dup_overscan",
             str(pipe.dup_overscan), "--dup_tails", tails, "--exact_extra",
             str(pipe.exact_extra), "--grad_reduce", pipe.grad_reduce,
             "--grad_sort", pipe.grad_sort, "--resolution", "1", "--eval",
             "--seed", "0", "--device", dev.type]
    densify = ["--densify_from_iter", str(FT_DENSIFY[0] - 1),
               "--densification_interval", str(FT_DENSIFY[0]),
               "--densify_until_iter", str(FT_DENSIFY[-1] + 1)]
    argv = ["full-train", "--project_dir", str(root), "--disable_viewer",
            "--skip_if_exists", "--skybox_num_override", str(FT_SKYBOX),
            "--iterations", str(FT_CHUNK), *densify, *flags]
    real_run = ft.full_train
    returned = []

    def cut_depth(*a, **k):
        returned.append(real_run(*a, **{**k, "coarse_iterations": FT_COARSE,
                                        "chunk_iterations": FT_CHUNK,
                                        "post_iterations": FT_POST}))
        return returned[-1]

    stages = {}
    native.reset_launches()
    ft.full_train = cut_depth
    try:
        with stage_probes(stages, keep=(FT_TIMED,)) as probe, \
                contextlib.redirect_stdout(sys.stderr):
            s0 = time.perf_counter()
            if cli.main(argv) != 0:
                raise AssertionError("full_train: full-train returned nonzero")
            run_s = time.perf_counter() - s0

            # The tau sweep of the merged tree on the held-out view.
            s0 = time.perf_counter()
            eval_dir = root / "output" / "eval"
            with probe["open"]("render_hierarchy"):
                rc = cli.main([
                    "render-hierarchy", "--hierarchy",
                    str(paths.output_dir / "merged.hier.npz"), "-s",
                    str(paths.colmap_dir), "--images", str(paths.images_dir),
                    "--depths", str(paths.depths_dir), "--model_path",
                    str(eval_dir), "--taus", *[f"{t:g}" for t in TAUS],
                    *flags])
            if rc != 0:
                raise AssertionError("full_train: render-hierarchy failed")
            eval_s = time.perf_counter() - s0

            # The rerun: every stage skipped, the merged tree returned.
            log = paths.output_dir / "training_pipeline_timing.txt"
            logged = log.read_text().splitlines()
            stamp = (paths.output_dir / "merged.hier.npz").stat().st_mtime_ns
            buf = io.StringIO()
            s0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                if cli.main(argv) != 0:
                    raise AssertionError("full_train: the rerun failed")
            rerun_s = time.perf_counter() - s0
            rerun_out = buf.getvalue()
            print(rerun_out, file=sys.stderr)
    finally:
        ft.full_train = real_run
    launches = dict(native.LAUNCHES)
    merged = returned[-1]
    again = log.read_text().splitlines()[len(logged):]
    if not ("Skipping coarse" in rerun_out
            and all(f"Skipping chunk {c}" in rerun_out for c in ("0_0", "1_0"))
            and "== Stage 2" not in rerun_out
            and [ln.split(":")[0] for ln in again] == ["consolidation"]
            and (paths.output_dir / "merged.hier.npz").stat().st_mtime_ns
            == stamp and merged is not None):
        raise AssertionError(f"full_train: the rerun did not skip: "
                             f"{rerun_out!r} {again}")

    # Artifacts, the timing log, the merged tree.
    want = [paths.scaffold_dir / "point_cloud" / f"iteration_{FT_COARSE}",
            paths.output_dir / "merged.hier.npz", eval_dir / "results.json"]
    for c in ("0_0", "1_0"):
        out = paths.trained_chunks_dir / c
        want += [out / "point_cloud" / f"iteration_{FT_CHUNK}",
                 out / "hierarchy.hier.npz", out / "hierarchy.hier_opt.npz",
                 out / "exposure.json"]
    missing = [str(p) for p in want if not p.exists()]
    if missing:
        raise AssertionError(f"full_train: missing {missing}")
    timing = {ln.split(":")[0]: float(ln.split(":")[1].split()[0])
              for ln in logged}
    names = ["coarse"] + [f"chunk_{c}_{s}" for c in ("0_0", "1_0")
                          for s in ("train", "hierarchy", "post")] + [
        "consolidation"]
    if [ln.split(":")[0] for ln in logged] != names:
        raise AssertionError(f"full_train: timing log {logged}")
    chunk_nodes = []
    for c in ("0_0", "1_0"):
        with np.load(paths.trained_chunks_dir / c /
                     "hierarchy.hier_opt.npz") as z:
            chunk_nodes.append(int(z["parent"].shape[0]))
    roots = int((merged.parent < 0).sum())
    if merged.n_nodes != sum(chunk_nodes) + 1 or roots != 1:
        raise AssertionError(f"full_train: merged {merged.n_nodes} nodes "
                             f"from {chunk_nodes}, {roots} roots")

    # Each stage: kernels launched, the loss falling, no overflow.
    report = {}
    for name in names:
        rec = stages[name]
        entry = {"seconds": timing[name], "launches": rec["launches"],
                 "peak_memory_bytes": rec["peak_memory_bytes"]}
        if rec["step_ms"]:
            entry["step_ms_median"] = statistics.median(
                rec["step_ms"][WARMUP_STEPS:])
            entry["steps"] = len(rec["step_ms"])
        if name.endswith("hierarchy") or name == "consolidation":
            report[name] = entry
            continue
        for key in ("blend_exact", "blend_exact_bwd", "slab_gather"):
            if not rec["launches"].get(key):
                raise AssertionError(f"full_train: stage {name} never "
                                     f"launched {key}")
        if rec["loops"]:
            (loop,) = rec["loops"]
            st = loop["stats"]
            losses = st["losses"]
            grew = st["exact_growths"] > 0
            if not (all(math.isfinite(v) for v in losses)
                    and statistics.mean(losses[-4:])
                    < statistics.mean(losses[:4])):
                raise AssertionError(f"full_train: stage {name} losses "
                                     f"{losses}")
            if not grew and (st["tile_overflow"] or st["skipped_updates"]):
                raise AssertionError(f"full_train: stage {name} overflowed "
                                     f"{st['tile_overflow']} pair slots, "
                                     f"{st['skipped_updates']} skipped")
            entry.update(
                losses=losses, tile_overflow=st["tile_overflow"],
                dup_overflow=st["dup_overflow"],
                skipped_updates=st["skipped_updates"],
                exact_growths=st["exact_growths"],
                exact_extra=st["final_pipe"].exact_extra,
                densify_active=st["n_active"],
                capacity=[loop["start_capacity"], loop["meta"].capacity],
                capacity_growths=st["overflows"])
        else:
            ovf = int(rec.get("post_tile_overflow", 0))
            if ovf:
                raise AssertionError(f"full_train: stage {name} post steps "
                                     f"overflowed {ovf} pair slots")
            entry["tile_overflow"] = ovf
        report[name] = entry
    res = json.loads((eval_dir / "results.json").read_text())
    psnr0, psnr15 = res["0.0"]["psnr"], res["15.0"]["psnr"]
    # The merged tree's cut of the held-out view at each tau (nodes).
    held = scene.cameras[-1]
    cut_nodes = {f"{t:g}": int(select_cut(merged, held.campos, pixel_limit(
        t, float(held.tan_fovx), held.width)).selected.sum()) for t in TAUS}
    if not (math.isfinite(psnr0) and psnr0 > FT_PSNR_MIN
            and psnr15 <= psnr0):
        raise AssertionError(f"full_train: tau sweep {res}")

    # The module entry in a process of its own, on the card: the blocks
    # this process keeps cached are handed back first.
    torch.cuda.empty_cache()
    s0 = time.perf_counter()
    sub_dir = root / "output" / "subprocess_eval"
    proc = subprocess.run(
        [sys.executable, "-m", "street_sparse_3dgs_tpu_torch.cli",
         "render-hierarchy", "--hierarchy",
         str(paths.trained_chunks_dir / "0_0" / "hierarchy.hier_opt.npz"),
         "-s", str(paths.chunks_dir / "0_0"), "--images",
         str(paths.images_dir), "--model_path", str(sub_dir), "--taus", "6",
         "--no_lpips", *flags], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    sub_s = time.perf_counter() - s0
    if proc.returncode != 0 or not (sub_dir / "results.json").exists():
        raise AssertionError(f"full_train: python -m ...cli failed: "
                             f"{proc.returncode} {proc.stderr[-2000:]}")
    sub_res = json.loads((sub_dir / "results.json").read_text())
    if not math.isfinite(sub_res["6.0"]["psnr"]):
        raise AssertionError(f"full_train: subprocess eval {sub_res}")

    # The viewer: train-single with the viewer on, a client asking for
    # frames; then ViewerHook on its saved state against the plain render.
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    cam = scene.cameras[0]
    client = {}
    thread = threading.Thread(target=viewer_client,
                              args=(port, cam, FT_FRAMES, client),
                              daemon=True)
    single = root / "output" / "single_viewer"
    s0 = time.perf_counter()
    thread.start()
    with stage_probes(stages) as probe, \
            contextlib.redirect_stdout(sys.stderr), \
            probe["open"]("train_single_viewer"):
        rc = cli.main(["train-single", "-s", str(paths.chunks_dir / "0_0"),
                       "--images", str(paths.images_dir), "--model_path",
                       str(single), "--iterations", str(FT_VIEWER_STEPS),
                       "--port", str(port), "--densify_from_iter", "1000",
                       *flags])
    thread.join(timeout=120)
    viewer_s = time.perf_counter() - s0
    launches = {k: launches[k] + stages["train_single_viewer"][
        "launches"].get(k, 0) for k in launches}
    frames = client.get("frames", [])
    if rc != 0 or thread.is_alive() or not frames or \
            client.get("verify") != str(paths.chunks_dir / "0_0") or \
            frames[0].shape != (HEIGHT, WIDTH, 3) or \
            float(np.std(frames[0])) == 0.0 or \
            not (single / "cfg_args").exists():
        raise AssertionError(f"full_train: viewer run rc {rc}, client "
                             f"{ {k: v for k, v in client.items() if k != 'frames'} }")
    params, sky = load_scene_ply(single / "point_cloud" /
                                 f"iteration_{FT_VIEWER_STEPS}", device=dev)
    n = params.xyz.shape[0]
    meta = GaussianMeta(sh_degree=3, capacity=n, skybox_points=sky)
    state = init_state(params, torch.ones(n, dtype=torch.bool, device=dev),
                       1)
    view, proj = wire_matrices(cam)
    req = ViewerRequest(
        width=cam.width, height=cam.height,
        fovx=2 * math.atan(float(cam.tan_fovx)),
        fovy=2 * math.atan(float(cam.tan_fovy)), znear=0.01, zfar=100.0,
        do_training=True, keep_alive=True, scaling_modifier=1.0,
        view_matrix=view, view_projection=proj)
    gui = _OneRequest(req)
    hook = ViewerHook(gui, "final", pipe)
    native.reset_launches()
    hook(state, meta)
    hook_launches = dict(native.LAUNCHES)
    plain = plain_render((params.xyz, activate_scales(params), params.quats,
                          activate_opacity(params, meta), sh_coeffs(params)),
                         req.camera(device=dev), raster_config(pipe),
                         torch.zeros(3, device=dev))
    frame = torch.as_tensor(gui.frame, device=dev)
    over = int(((frame - plain).abs().amax(dim=0) > IMG_ATOL).sum())
    if tuple(frame.shape) != (3, HEIGHT, WIDTH) or \
            over > FLIP_SHARE * HEIGHT * WIDTH or \
            not hook_launches["blend_exact"]:
        raise AssertionError(f"full_train: the hook's frame has {over} "
                             f"pixels over {IMG_ATOL} against the plain "
                             f"render; launches {hook_launches}")
    torch.cuda.synchronize()
    emit({"phase": "full_train", "seconds": time.perf_counter() - t0,
          "views": len(scene.cameras), "width": WIDTH,
          "height": HEIGHT, "rows": rows, "project_write_seconds": write_s,
          "depth": {"coarse": FT_COARSE, "chunk": FT_CHUNK,
                    "densify_at": list(FT_DENSIFY), "post": FT_POST},
          "budgets": budgets, "argv": argv, "run_seconds": run_s, "stage_seconds": timing,
          "stages": report, "chunk_nodes": chunk_nodes,
          "merged_nodes": merged.n_nodes,
          "eval_seconds": eval_s, "eval": res, "cut_nodes": cut_nodes,
          "rerun_seconds": rerun_s, "rerun_skipped": True,
          "subprocess_seconds": sub_s, "subprocess_eval": sub_res,
          "viewer_seconds": viewer_s, "viewer_frames": len(frames),
          "viewer_latency_ms": client["latency_ms"],
          "hook_pixels_over_atol": over,
          "hook_max_abs_err": float((frame - plain).abs().max()),
          "launches": launches})
    return {"launches": launches, "timed": stages[FT_TIMED]["calls"],
            "checks": {k: v["checks"] for k, v in stages.items()
                       if v.get("checks")}}


def grads_small(dev) -> dict:
    """``rasterize`` and its backward on a toy scene (SMALL_N Gaussians,
    SMALL_W x SMALL_H) on the card (kernels) and on the CPU (plain
    versions): grads of the rows and bg within GRAD_BAR * max|g| +
    GRAD_RTOL * |g| of the CPU's, in the padded and the exact+counts
    config."""
    from street_sparse_3dgs_tpu_torch.data.toy import make_toy_scene
    from street_sparse_3dgs_tpu_torch.ops.rasterize import (RasterConfig,
                                                            rasterize)
    cfgs = {"padded": RasterConfig(method="pallas", max_dup=32,
                                   tile_capacity=256),
            "exact_counts": RasterConfig(method="pallas", max_dup=32,
                                         tile_capacity=128, exact_extra=256,
                                         grad_reduce="counts")}
    names = ("means3d", "scales", "quats", "opacities", "sh", "bg")
    res = {}
    for cname, cfg in cfgs.items():
        grads, overflow = [], []
        for d in (dev, torch.device("cpu")):
            s = make_toy_scene(seed=0, n=SMALL_N, n_cameras=1, width=SMALL_W,
                               height=SMALL_H, device=d)
            leaves = [x.clone().requires_grad_(True) for x in (
                s.means3d, s.scales, s.quats, s.opacities, s.sh_coeffs,
                torch.tensor([0.2, 0.1, 0.3], device=d))]
            out = rasterize(*leaves[:5], s.cameras[0], 3, leaves[5], cfg)
            loss = (torch.mean(out["render"] ** 2)
                    + 0.3 * torch.mean(out["depth"])
                    + 0.1 * torch.mean(out["alpha"] ** 2))
            loss.backward()
            grads.append([x.grad.cpu().double() for x in leaves])
            overflow.append(int(out["tile_overflow"]))
        per = {}
        for name, got, want in zip(names, *grads):
            scale = float(want.abs().max())
            diff = (got - want).abs()
            outside = int((diff > GRAD_BAR * scale
                           + GRAD_RTOL * want.abs()).sum())
            per[name] = {"max_scaled_err": float(diff.max()) / scale,
                         "outside_bar": outside}
            if outside or scale == 0.0:
                raise AssertionError(f"grads_small {cname} {name}: {outside} "
                                     f"elements outside the bar, max|g| "
                                     f"{scale}: {per[name]}")
        if cfg.exact_extra and any(overflow):
            raise AssertionError(f"grads_small {cname}: tile_overflow "
                                 f"{overflow}")
        res[cname] = {"grads": per, "tile_overflow": overflow}
    return res


def fwd_bound(args, out, exact: bool, sfu_rate: float):
    """(bound ms, bound_by, live slots, walk counts) of a forward blend
    call: bytes = live attrs (10 f32 each) + per-tile int32 metadata + the
    [T, 8, 256] output; operations = the power at every (slot, pixel) step
    the call walked and the rest of the step at those that pass the alpha
    test (``walk_counts``)."""
    if exact:
        per_tile = tile_pairs(*args[1:4])
        vec_reads = 2 * args[1].shape[0] + args[3].shape[0]
    else:
        per_tile = torch.clamp(args[1].to(torch.int64), max=args[0].shape[2])
        vec_reads = args[1].shape[0]
    counts = walk_counts(args, out, exact, 1)
    walk, passed = counts["walked_steps"], counts["passing_steps"]
    live = int(per_tile.sum())
    ms, by = bound(live * 40 + vec_reads * 4 + out.shape[0] * 8 * 256 * 4,
                   passed * SFU_PER_PASS,
                   walk * FLOPS_PER_WALK + passed * FLOPS_PER_PASS, sfu_rate)
    return ms, by, live, counts


def bwd_bound(args, exact: bool, sfu_rate: float):
    """(bound ms, bound_by, live slots, walk counts) of a backward blend
    call: bytes = live attrs (10 f32 each) + per-tile int32 metadata + the
    rows the kernel reads of saved (log T, n_contrib) and of the cotangent
    (R, G, B, invdepth, alpha) + the grads it writes; operations = the
    power at each pixel's slots below its n_contrib and the rest of the
    step at those that pass the alpha test."""
    if exact:
        attrs, vcounts, wt, last_v, _, saved = args[:6]
        per_tile = tile_pairs(vcounts, wt, last_v)
        windows = int((wt.to(torch.int64)[last_v.to(torch.int64)] + 1).sum())
        out_bytes = windows * attrs.shape[1] * 10 * 4
        vec_reads = 2 * vcounts.shape[0] + last_v.shape[0]
        fwd_args = args[:5] + args[7:]
    else:
        attrs, counts, bg, saved = args[:4]
        per_tile = torch.clamp(counts.to(torch.int64), max=attrs.shape[2])
        out_bytes = attrs.numel() * 4
        vec_reads = counts.shape[0] + bg.numel()
        fwd_args = args[:3] + args[5:]
    t = saved.shape[0]
    live = int(per_tile.sum())
    counts = walk_counts(fwd_args, saved, exact, 0)
    walk, passed = counts["walked_steps"], counts["passing_steps"]
    bytes_ = live * 40 + vec_reads * 4 + t * 7 * 256 * 4 + out_bytes
    ms, by = bound(bytes_, passed * SFU_PER_PASS,
                   walk * FLOPS_PER_WALK + passed * BWD_FLOPS_PER_PASS,
                   sfu_rate)
    return ms, by, live, counts


def k4_checks(args, ms: float) -> dict:
    """K4 on recorded inputs ``args``: two launches bit-identical, and the
    deepest tile (the first of ``exact_tile_order``) launched alone
    (``order=[deepest]``, one block): its windows' grads equal the full
    launch's and no other window gets any.  Returns the deepest tile's
    windows, slots, device ms and share of the full launch's ``ms``."""
    from street_sparse_3dgs_tpu_torch.ops import cuda_blend as cb
    from street_sparse_3dgs_tpu_torch.profiling import device_ms
    _, vcounts, wt, last_v = args[:4]
    full = cb.blend_exact_bwd(*args)
    if not torch.equal(full, cb.blend_exact_bwd(*args)):
        raise AssertionError("K4: two launches differ")
    deep = cb.exact_tile_order(wt, last_v)[:1].contiguous()
    t = int(deep[0])
    v_last = int(last_v[t])
    v_first = v_last - int(wt[v_last])
    alone = cb.blend_exact_bwd(*args, order=deep)
    if not (torch.equal(alone[v_first:v_last + 1], full[v_first:v_last + 1])
            and not alone[:v_first].any() and not alone[v_last + 1:].any()):
        raise AssertionError("K4: the deepest tile launched alone differs "
                             "from the full launch")
    # Timed past the wrapper's checks of ``order``, which read it back.
    deep_ms = device_ms(lambda: cb.blend_exact_bwd_launch(
        *args[:7], *(list(args[7:]) + [0])[:2], deep), 10)
    return {"tile": t, "windows": v_last - v_first + 1,
            "slots": int(tile_pairs(vcounts, wt, last_v)[t]),
            "ms": deep_ms, "share_of_launch": deep_ms / ms}


def k2_launch_floor(args, reps: int, ms: float) -> dict:
    """K2's launch floor at the shapes of a recorded call ``args``: the
    device time of the same launch with every count 0 (no slot walked,
    every grad still written as a zero).  The walk is launch-floor-bound
    where the floor is at least half of the call's device ``ms``."""
    from street_sparse_3dgs_tpu_torch.ops import cuda_blend as cb
    from street_sparse_3dgs_tpu_torch.profiling import device_ms
    empty = (args[0], torch.zeros_like(args[1])) + tuple(args[2:])
    floor = device_ms(lambda: cb.blend_padded_bwd(*empty), reps)
    return {"launch_floor_ms": floor, "launch_floor_share": floor / ms,
            "launch_floor_bound": floor >= 0.5 * ms}


def k3_checks(args, ms: float) -> dict:
    """K3 on recorded inputs ``args``: two launches bit-identical, and the
    deepest tile (the first of ``exact_tile_order``) launched alone
    (``order=[deepest]``, one block) gives the full launch's rows for that
    tile.  Returns, timed beside the default (tile order, the split), the
    launch with the tiles deepest first and the launch with no split (every
    tile one block), the real tiles by window count, and the deepest tile's
    windows, slots, device ms and share of the full launch's ``ms``."""
    from street_sparse_3dgs_tpu_torch.ops import cuda_blend as cb
    from street_sparse_3dgs_tpu_torch.profiling import device_ms
    _, vcounts, wt, last_v = args[:4]
    tiles_x, t_mod = (list(args[5:]) + [0])[:2]
    full = cb.blend_exact(*args)
    if not torch.equal(full, cb.blend_exact(*args)):
        raise AssertionError("K3: two launches differ")
    deepest_first = cb.exact_tile_order(wt, last_v)
    if not torch.equal(cb.blend_exact(*args, order=deepest_first), full):
        raise AssertionError("K3: deepest first differs from tile order")
    deep = deepest_first[:1].contiguous()
    t = int(deep[0])
    v_last = int(last_v[t])
    alone = cb.blend_exact(*args, order=deep)
    if not torch.equal(alone[t], full[t]):
        raise AssertionError("K3: the deepest tile launched alone differs "
                             "from the full launch")

    # Timed past the wrapper's checks of ``order``, which read it back.
    def launch(order, group=cb.EXACT_GROUP):
        return lambda: cb.blend_exact_launch(*args[:5], tiles_x, t_mod,
                                             order, group)
    deep_ms = device_ms(launch(deep), 10)
    return {"bit_identical_reruns": True,
            "deepest_first_ms": device_ms(launch(deepest_first), 20),
            "no_split_ms": device_ms(launch(None, 0), 20),
            **window_histogram(wt, last_v),
            "deepest_tile": {
                "tile": t, "windows": int(wt[v_last]) + 1,
                "slots": int(tile_pairs(vcounts, wt, last_v)[t]),
                "ms": deep_ms, "share_of_launch": deep_ms / ms}}


def window_histogram(wt, last_v) -> dict:
    """Real tiles by their number of windows."""
    nw = (wt.to(torch.int64)[last_v.to(torch.int64)] + 1)
    edges = ((1, 1), (2, 2), (3, 4), (5, 8), (9, 16), (17, 32), (33, 1 << 30))
    hist = {f"{a}" if a == b else (f"{a}-{b}" if b < 1 << 30 else f"{a}+"):
            int(((nw >= a) & (nw <= b)).sum()) for a, b in edges}
    return {"tiles_by_windows": hist, "max_windows": int(nw.max()),
            "windows": int(nw.sum())}


def walk_counts(args, out, exact: bool, reach: int) -> dict:
    """The (slot, pixel) steps of a blend call on forward inputs ``args``
    and forward output ``out``: each pixel walks slot j while j <
    min(n_contrib + ``reach``, live) (a forward also meets its terminating
    slot: 1; a backward recounts n_contrib: 0).  Counts the walked steps,
    those that pass the alpha test (power <= 0 and alpha >= 1/255), and the
    warp-slots (a warp is 32 pixels of a tile) walked and with at least one
    passing pixel: the rest are what a warp skip ahead of exp can leave
    out.  From the call's attrs, on the card, in chunks of tiles."""
    from street_sparse_3dgs_tpu_torch.ops import cuda_blend as cb
    attrs, dev = args[0], args[0].device
    if exact:
        vcounts, wt, last_v = args[1:4]
        tiles_x, t_mod = (list(args[5:]) + [0])[:2]
        chunks = ((s, e, attrs[v].reshape(e - s, -1, 10).transpose(1, 2),
                   total, cb._tile_mod(torch.arange(s, e, device=dev), t_mod))
                  for s, e, v, _, total in cb._exact_chunks(
                      vcounts, wt, last_v, attrs.shape[1], 1 << 24))
    else:
        tiles_x, tile0, t_mod = (list(args[3:]) + [0, 0])[:3]
        k = attrs.shape[2]
        live = torch.clamp(args[1].to(torch.int64), max=k)
        step = max(1, (1 << 24) // (256 * k))

        def padded_chunks():
            for s in range(0, attrs.shape[0], step):
                e = min(attrs.shape[0], s + step)
                tiles = torch.arange(s, e, device=dev) + tile0
                yield (s, e, attrs[s:e], live[s:e],
                       tiles % t_mod if t_mod else tiles)
        chunks = padded_chunks()
    walked_ws = passed_ws = walked_steps = passed_steps = 0
    for s, e, slots, total, tiles in chunks:
        ok = cb.slot_alpha(slots, total, tiles, tiles_x)[1]  # [C, 256, L]
        upto = torch.minimum(out[s:e, 6].to(torch.int64) + reach,
                             total.to(torch.int64)[:, None])
        lane = (torch.arange(slots.shape[2], device=dev)[None, None, :]
                < upto[:, :, None])                         # [C, 256, L]
        c, ell = e - s, slots.shape[2]
        passed = ok & lane
        walked_steps += int(lane.sum())
        passed_steps += int(passed.sum())
        walked_ws += int(lane.view(c, 8, 32, ell).any(dim=2).sum())
        passed_ws += int(passed.view(c, 8, 32, ell).any(dim=2).sum())
    return {"walked_steps": walked_steps, "passing_steps": passed_steps,
            "walked_warp_slots": walked_ws, "passing_warp_slots": passed_ws,
            "warp_slot_pass_share": passed_ws / max(walked_ws, 1)}


# ---- phase parallel: the multi-rank layer ----------------------------------

# Steps of each parallel training run and timed renders, each after
# PAR_WARMUP uncounted-for-time warm-ups (all counted for launches).
PAR_STEPS, PAR_WARMUP, PAR_RENDERS = 3, 1, 3
# The (2 x 2) cell, cut from the street scene's 1M rows at 1920x1088: four
# ranks' replicated binning of the full scene would not fit one card.
PAR_REDUCED_N, PAR_REDUCED_W, PAR_REDUCED_H = 200_000, 960, 544
PAR_TIMEOUT = 600.0          # s a world may run before it counts as hung
# The exact window budget of a sharded run: the worst shard's need on the
# views' pre-clip counts times this margin (the steps move the rows).
PAR_BUDGET_MARGIN = 1.25


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def shard_budget(counts_list, k_cap: int, n: int) -> int:
    """An exact window budget (a multiple of ``n``) under which no shard of
    ``n`` overflows on the views' pre-clip tile counts ``counts_list``,
    with PAR_BUDGET_MARGIN headroom, and at least the street config's
    9,216."""
    need = 0
    for counts in counts_list:
        t = counts.shape[0]
        c = torch.zeros(-(-t // n) * n, dtype=torch.int64,
                        device=counts.device)
        c[:t] = counts
        extra = torch.clamp(-torch.div(-c, k_cap, rounding_mode="floor"),
                            min=1) - 1
        need = max(need, int(extra.reshape(n, -1).sum(dim=1).max()))
    e = max(9216, math.ceil(need * n * PAR_BUDGET_MARGIN))
    return -(-e // n) * n


def ring_sizing(rows, cam) -> tuple:
    """(max_dup, K) under which the ring's rectangle pairs neither drop a
    tile of any row nor overflow a tile: the largest covered tile rectangle
    and the deepest tile's rectangle count (rounded up to 128), from a 2-D
    difference array over the tile grid."""
    from street_sparse_3dgs_tpu_torch.ops.binning import num_tiles, tile_rect
    from street_sparse_3dgs_tpu_torch.ops.preprocess import project_gaussians
    with torch.no_grad():
        proj = project_gaussians(*rows, cam, 3)
        tx, ty = num_tiles(cam.height, cam.width)
        x0, y0, x1, y1 = (v.to(torch.int64)[proj.valid] for v in tile_rect(
            proj.mean2d, proj.radius, tx, ty))
        diff = torch.zeros((ty + 1) * (tx + 1), dtype=torch.int64,
                           device=x0.device)
        for yy, xx, s in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1),
                          (y1, x1, 1)):
            diff.index_add_(0, yy * (tx + 1) + xx, torch.full_like(yy, s))
        grid = diff.reshape(ty + 1, tx + 1).cumsum(0).cumsum(1)
        return (int(((x1 - x0) * (y1 - y0)).max()),
                128 * -(-int(grid.max()) // 128))


@contextlib.contextmanager
def par_counted(dev, rec: dict):
    """The counted main-path run of a rank: launch counts and the host
    transport zeroed at entry and read at exit, with the peak memory and
    seconds of the block."""
    from street_sparse_3dgs_tpu_torch import native
    from street_sparse_3dgs_tpu_torch.parallel import collectives
    native.reset_launches()
    collectives.reset_transport()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    yield
    sync(dev)
    rec.update(seconds=time.perf_counter() - t0,
               launches=dict(native.LAUNCHES),
               transport=dict(collectives.TRANSPORT),
               peak_bytes=torch.cuda.max_memory_allocated(dev)
               if dev.type == "cuda" else 0)


def par_timed(dev, fn, n: int) -> tuple:
    """(host ms of each of ``n`` synchronised calls, the last result)."""
    ms, out = [], None
    for _ in range(n):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, out


def held_parallel(kf: "Recorder", kb: "Recorder", exact: bool) -> dict:
    """A rank's first recorded blend call (K1 or K3, with its keyword
    ``tile0``/``t_mod``/``order``) and its backward (K2 or K4) against the
    plain versions on the same inputs: the image bar with the flip share,
    GRAD_BAR x max|g| per channel."""
    from street_sparse_3dgs_tpu_torch.ops import cuda_blend as cb
    (args, out), kw = kf.calls[0], kf.kwargs[0]
    plain = cb.blend_exact_plain if exact else cb.blend_padded_plain
    cmp = compare_blend(out, plain(*args, **kw))
    name = "K3" if exact else "K1"
    check_blend(f"{name} at parallel", cmp, strict=False)
    grid = {k: (int(v.shape[0]) if isinstance(v, torch.Tensor) else v)
            for k, v in kw.items()}
    (bargs, bout), bkw = kb.calls[0], kb.kwargs[0]
    plain_b = cb.blend_exact_bwd_plain if exact else cb.blend_padded_bwd_plain
    gcmp = compare_grads(f"{'K4' if exact else 'K2'} at parallel", bout,
                         plain_b(*bargs, **bkw), 2 if exact else 1)
    return {"fwd": {"name": name, "tiles": int(out.shape[0]), **grid,
                    "per_tile_bg": int(args[4 if exact else 2].shape[0]) != 1,
                    "max_abs_err": cmp["max_abs_err"], "flips": cmp["flips"],
                    "pixels_over_atol": cmp["pixels_over_atol"]},
            "bwd": {"name": "K4" if exact else "K2",
                    "max_abs_err": gcmp["max_abs_err"],
                    "max_scaled_err": gcmp["max_scaled_err"]}}


def k4_rank_vs_whole(kf: "Recorder", kb: "Recorder") -> dict:
    """A rank's K4 call (its tiles through ``order``) against K4 over the
    whole view on the whole view's saved rows (K3 with no order) and the
    same cotangent: equal bit for bit on the rank's windows; the rank's
    call leaves every other window zero."""
    from street_sparse_3dgs_tpu_torch.ops import cuda_blend as cb
    k3_args = kf.calls[0][0]
    (args, out), kw = kb.calls[0], kb.kwargs[0]
    attrs, vcounts, wt, last_v, bg, _, g_out, tiles_x, t_mod = args
    whole = cb.blend_exact_bwd(attrs, vcounts, wt, last_v, bg,
                               cb.blend_exact(*k3_args), g_out, tiles_x,
                               t_mod)
    v_last = last_v.to(torch.int64)[kw["order"].to(torch.int64)]
    first = v_last - wt.to(torch.int64)[v_last]
    win = torch.zeros(attrs.shape[0] + 1, dtype=torch.int64,
                      device=attrs.device)
    win.index_add_(0, first, torch.ones_like(first))
    win.index_add_(0, v_last + 1, -torch.ones_like(first))
    mine = torch.cumsum(win, 0)[:-1] > 0
    equal = torch.equal(whole[mine], out[mine]) and not bool(out[~mine].any())
    if not equal:
        raise AssertionError("K4 at parallel: a rank's grads differ from "
                             "the whole view's on its windows")
    return {"windows": int(mine.sum()), "bit_identical": equal}


class ParCtx:
    """What a rank of phase parallel's worlds shares between its cases:
    the inputs the parent saved, the scenes (made here from their seeds),
    and the meshes (made once each: every rank makes them in one order)."""

    def __init__(self, rank: int, world: int, spec: dict):
        from street_sparse_3dgs_tpu_torch.parallel.dryrun import rank_device
        self.rank, self.world, self.spec = rank, world, spec
        self.dev = rank_device(spec["device"], rank)
        self.inp = torch.load(spec["inputs"], weights_only=False)
        self._scenes, self._meshes = {}, {}

    def scene(self, key: str):
        from street_sparse_3dgs_tpu_torch.data.toy import make_street_scene
        if key not in self._scenes:
            n, views, w, h = self.inp["scenes"][key]
            s = make_street_scene(seed=0, n=n, n_cameras=views, width=w,
                                  height=h, device=self.dev)
            self._scenes[key] = ((s.means3d, s.scales, s.quats, s.opacities,
                                  s.sh_coeffs), s.cameras)
        return self._scenes[key]

    def mesh(self, n_data: int, n_tile: int):
        from street_sparse_3dgs_tpu_torch.parallel.mesh import make_mesh
        if (n_data, n_tile) not in self._meshes:
            self._meshes[n_data, n_tile] = make_mesh(n_data, n_tile,
                                                     device=self.dev)
        return self._meshes[n_data, n_tile]

    def batches(self, key: str):
        rows, cams = self.scene(key)
        return camera_batches(cams, [g.to(self.dev) for g in
                                     self.inp["gts"][key]], self.dev)

    def start(self, key: str):
        """The trainee's start state on the scene ``key`` (whole rows)."""
        from street_sparse_3dgs_tpu_torch.train.step import init_state
        rows, cams = self.scene(key)
        params = start_params(rows, 1, self.dev)
        n = params.xyz.shape[0]
        return (init_state(params, torch.ones(n, dtype=torch.bool,
                                              device=self.dev), len(cams)),
                _meta(n))


def checksum(*xs) -> list:
    """float64 sums: what a rank's replicated results must share."""
    return [float(x.detach().double().sum()) for x in xs]


def state_record(state, rows=None) -> dict:
    """The state's params and statistics on the CPU (``rows`` a slice of
    the rows to keep, or all)."""
    sl = rows if rows is not None else slice(None)
    return {"params": {k: v[sl].detach().cpu()
                       for k, v in state.params._asdict().items()},
            "exposure": state.exposure.detach().cpu(),
            **{k: getattr(state, k)[sl].detach().cpu()
               for k in ("grad_accum", "denom", "max_radii2d")}}


def par_render(ctx: ParCtx, cfg, ring: bool = False) -> dict:
    """The tile-sharded (or, with ``ring``, ring-staged) render of the
    street scene's view 0 on a (1 x world) mesh, forward and the backward
    of mean(render^2), PAR_WARMUP + PAR_RENDERS times; then, uncounted, the
    first blend and backward calls of one more run held against the plain
    versions (and for the exact path a rank's K4 against the whole
    view's)."""
    from street_sparse_3dgs_tpu_torch.ops import cuda_blend as cb
    from street_sparse_3dgs_tpu_torch.parallel.ring import (
        rasterize_ring_staged)
    from street_sparse_3dgs_tpu_torch.parallel.tiles import (
        rasterize_tile_sharded)
    rows, cams = ctx.scene("street")
    mesh = ctx.mesh(1, ctx.world)
    bg = torch.zeros(3, device=ctx.dev)
    if ring:
        blk = rows[0].shape[0] // ctx.world
        rows = tuple(x[ctx.rank * blk:(ctx.rank + 1) * blk] for x in rows)
    fn = rasterize_ring_staged if ring else rasterize_tile_sharded

    def fwd_bwd():
        leaves = [r.detach().requires_grad_(True) for r in rows]
        out = fn(*leaves, cams[0], 3, bg, mesh, cfg)
        torch.mean(out["render"] ** 2).backward()
        return out, [x.grad for x in leaves]

    rec = {}
    with par_counted(ctx.dev, rec):
        ms, (out, grads) = par_timed(ctx.dev, fwd_bwd,
                                     PAR_WARMUP + PAR_RENDERS)
    img = torch.cat([out["render"], out["depth"], out["alpha"][None]])
    rec.update(ms=ms, ms_median=statistics.median(ms[PAR_WARMUP:]),
               checksum=checksum(img, *([] if ring else grads)),
               overflow={k: int(out[k]) for k in
                         ("tile_overflow", "dup_overflow", "pair_overflow")
                         if k in out})
    if ctx.rank == 0:
        rec["image"] = img.detach().cpu()
    if ring or ctx.rank == 0:
        rec["grads"] = [g.cpu() for g in grads]
    del out, grads, img
    if not ring:
        exact = bool(cfg.exact_extra)
        name = "blend_exact" if exact else "blend_padded"
        with Recorder(cb, name, first_only=True) as kf, \
                Recorder(cb, name + "_bwd", first_only=True) as kb:
            fwd_bwd()
        rec["held"] = held_parallel(kf, kb, exact)
        if exact:
            rec["k4_rank_vs_whole"] = k4_rank_vs_whole(kf, kb)
    return rec


def par_steps(ctx: ParCtx, kind: str, pipe, key: str, views: list,
              n_data: int, n_tile: int, repeat: int = 1) -> dict:
    """PAR_STEPS steps of the ``kind`` step ("dp", "tp" or "ring") on a
    (n_data x n_tile) mesh over the scene ``key``: step s takes the views
    ``views[s]`` (a list) with the backgrounds the parent drew; ``repeat``
    runs it again from the start (the second run's state must equal the
    first's bit for bit).  Records losses, counters, step ms and the final
    state (rank 0; every rank its own rows in the ring); for the tp step
    the first K1/K3 and K2/K4 calls of one more step, held against the
    plain versions."""
    from street_sparse_3dgs_tpu_torch.config import OptimizationConfig
    from street_sparse_3dgs_tpu_torch.ops import cuda_blend as cb
    from street_sparse_3dgs_tpu_torch.parallel import dp, ring, tp
    mesh = ctx.mesh(n_data, n_tile)
    batches = ctx.batches(key)
    bgs = ctx.inp["bgs"][key].to(ctx.dev)                 # [steps, V, 3]
    state0, meta = ctx.start(key)
    opt, scale = OptimizationConfig(), ctx.inp["extent"][key]
    if kind == "dp":
        step, shard_batch, shard_state = dp.make_dp_train_step(
            meta, opt, pipe, scale, mesh)

        def run(state, s):
            vs = views[s]
            return step(state, shard_batch([batches[v] for v in vs]),
                        shard_batch(bgs[s, vs]))
    elif kind == "tp":
        step, shard_state = tp.make_tile_sharded_train_step(
            meta, opt, pipe, scale, mesh)

        def run(state, s):
            vs = views[s]
            return step(state, [batches[v] for v in vs], bgs[s, vs])
    else:
        step, shard_state = ring.make_ring_train_step(meta, opt, pipe, scale,
                                                      mesh)

        def run(state, s):
            v = views[s][0]
            return step(state, batches[v], bgs[s, v])

    rec, finals = {}, []
    for r in range(repeat):
        state, auxs, ms = shard_state(state0), [], []
        with contextlib.ExitStack() as stack:
            if r == 0:
                stack.enter_context(par_counted(ctx.dev, rec))
            for s in range(PAR_STEPS):
                sync(ctx.dev)
                t0 = time.perf_counter()
                state, aux = run(state, s)
                sync(ctx.dev)
                ms.append((time.perf_counter() - t0) * 1e3)
                auxs.append({k: float(v) for k, v in aux.items()})
        finals.append(state)
        if r == 0:
            rec.update(ms=ms, ms_median=statistics.median(ms[PAR_WARMUP:]),
                       aux=auxs)
    if repeat > 1:
        rec["bit_identical_rerun"] = all(bit_identical(finals[0], f)
                                         for f in finals[1:])
        if not rec["bit_identical_rerun"]:
            raise AssertionError(f"parallel {kind}: two runs differ")
    state = finals[0]
    rec["checksum"] = checksum(state.params.xyz, state.exposure)
    if kind == "ring" or ctx.rank == 0:
        rec["state"] = state_record(state)
    if kind == "tp":
        exact = bool(pipe.exact_extra)
        name = "blend_exact" if exact else "blend_padded"
        with Recorder(cb, name, first_only=True) as kf, \
                Recorder(cb, name + "_bwd", first_only=True) as kb:
            run(shard_state(state0), 0)
        rec["held"] = held_parallel(kf, kb, exact)
    return rec


def par_rank(rank: int, world: int, spec: dict) -> dict:
    """One rank of a world of phase parallel: ``spec["cases"]`` in order,
    each (name, function name in this module, keyword arguments)."""
    ctx = ParCtx(rank, world, spec)
    out = {}
    for name, fn, kw in spec["cases"]:
        if fn == "dryrun":
            from street_sparse_3dgs_tpu_torch.parallel.dryrun import (
                dryrun_rank)
            rec = {}
            with par_counted(ctx.dev, rec):
                rec["record"] = dryrun_rank(rank, world, spec["device"],
                                            kw["project"])
            out[name] = rec
        else:
            out[name] = globals()[fn](ctx, **kw)
    return out


def scene_extent(cams) -> float:
    """The spatial learning-rate scale: 1.1 x the largest distance of the
    camera centres from their mean (the reference's nerf++ norm)."""
    centres = torch.stack([c.campos for c in cams])
    return 1.1 * float(torch.linalg.vector_norm(
        centres - centres.mean(dim=0), dim=1).max())


def grads_within(name: str, got: list, want: list) -> dict:
    """Per parameter |got - want| <= GRAD_BAR x max|want| + GRAD_RTOL x
    |want| (JAX's bar, tests/test_parallel.py:66-67); returns each
    parameter's largest |got - want| / max|want|."""
    errs = []
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        g, w = g.to(w.device).double(), w.double()
        scale = float(w.abs().max()) + 1e-30
        excess = (g - w).abs() - GRAD_RTOL * w.abs() - GRAD_BAR * scale
        errs.append(float((g - w).abs().max()) / scale)
        if bool((excess > 0).any()):
            raise AssertionError(f"{name}: grads of parameter {i} off by "
                                 f"{errs[-1]} x max|g|")
    return {"max_scaled_err": errs}


def image_within(name: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    """Pixels of [5, H, W] (RGB, depth, alpha) off by more than IMG_ATOL:
    at most FLIP_SHARE of them (termination flips)."""
    err = (got.to(want.device) - want).abs().amax(dim=0)
    over = int((err > IMG_ATOL).sum())
    if over > FLIP_SHARE * err.numel():
        raise AssertionError(f"{name}: {over} pixels over {IMG_ATOL}")
    return {"max_abs_err": float(err.max()), "pixels_over_atol": over}


def states_within(name: str, got: dict, want: dict, opt, scale: float,
                  losses_got: list, losses_want: list) -> dict:
    """Two training runs' final states and losses: losses at rtol 1e-5,
    params within one Adam quantum (2.05 lr + 1e-5,
    tests/test_parallel.py:211-221), exposure at 1e-6, grad_accum and
    max_radii2d at 1e-5, denom equal."""
    lr = {"xyz": opt.position_lr_init * scale, "features_dc": opt.feature_lr,
          "features_rest": opt.feature_lr / 20.0,
          "opacity_raw": opt.opacity_lr, "log_scales": opt.scaling_lr,
          "quats": opt.rotation_lr}
    dev_q = {}
    for k, q in lr.items():
        d = float((got["params"][k] - want["params"][k]).abs().max())
        dev_q[k] = d / q
        if d > 2.05 * q + 1e-5:
            raise AssertionError(f"{name}: {k} off by {d} (lr {q})")
    for a, b in zip(losses_got, losses_want, strict=True):
        if not math.isclose(a, b, rel_tol=1e-5, abs_tol=1e-6):
            raise AssertionError(f"{name}: losses {losses_got} against "
                                 f"{losses_want}")
    close = {k: float((got[k] - want[k]).abs().max())
             for k in ("exposure", "grad_accum", "max_radii2d", "denom")}
    if close["exposure"] > 1e-6 or close["grad_accum"] > 1e-5 or \
            close["max_radii2d"] > 1e-5 or close["denom"] != 0:
        raise AssertionError(f"{name}: statistics differ {close}")
    return {"param_dev_in_lr": dev_q, **close}


PAR_KERNELS = {"padded": ("slab_gather", "blend_padded", "blend_padded_bwd"),
               "exact": ("slab_gather", "blend_exact", "blend_exact_bwd"),
               "ring": ("blend_padded", "blend_padded_bwd"),
               "all": ("slab_gather", "blend_padded", "blend_padded_bwd",
                       "blend_exact", "blend_exact_bwd")}


def parallel_phase(dev, scene, street_pipe) -> dict:
    """Phase parallel: the port's ``parallel/`` on the card in three
    spawned worlds of ranks that share it (``gloo`` with W ranks,
    ``nccl`` with one), their main paths counted, checked against the
    serial path in this process; see the module docstring."""
    import dataclasses

    from street_sparse_3dgs_tpu_torch.config import (OptimizationConfig,
                                                     PipelineConfig)
    from street_sparse_3dgs_tpu_torch.data.toy import make_street_scene
    from street_sparse_3dgs_tpu_torch.ops import binning
    from street_sparse_3dgs_tpu_torch.ops.preprocess import project_gaussians
    from street_sparse_3dgs_tpu_torch.ops.rasterize import (bin_kwargs,
                                                           rasterize)
    from street_sparse_3dgs_tpu_torch.parallel.mesh import run_world
    from street_sparse_3dgs_tpu_torch.train.step import (init_state,
                                                         make_train_step,
                                                         raster_config)
    t0 = time.perf_counter()
    root = ROOT / "build" / "smoke" / "parallel"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    red = make_street_scene(seed=0, n=PAR_REDUCED_N, n_cameras=N_VIEWS,
                            width=PAR_REDUCED_W, height=PAR_REDUCED_H,
                            device=dev)
    scenes = {"street": ((scene.means3d, scene.scales, scene.quats,
                          scene.opacities, scene.sh_coeffs), scene.cameras),
              "reduced": ((red.means3d, red.scales, red.quats, red.opacities,
                           red.sh_coeffs), red.cameras)}
    street_cfg = raster_config(street_pipe)

    def counts(key, cam):
        rows = scenes[key][0]
        with torch.no_grad():
            proj = project_gaussians(*rows, cam, 3)
            return binning.bin_gaussians(
                proj, cam.height, cam.width, street_cfg.max_dup,
                street_cfg.tile_capacity, **bin_kwargs(street_cfg)).counts

    e2 = shard_budget([counts("street", c)
                       for c in scene.cameras[:PAR_STEPS]], 128, 2)
    e4 = shard_budget([counts("reduced", c) for c in red.cameras], 128, 4)
    exact2 = dataclasses.replace(street_pipe, exact_extra=e2)
    exact4 = dataclasses.replace(street_pipe, exact_extra=e4)
    padded = dataclasses.replace(street_pipe, exact_extra=0,
                                 tile_capacity=1024, grad_reduce="sort")
    ring_dup, ring_k = ring_sizing(scenes["street"][0], scene.cameras[0])
    ring_pipe = PipelineConfig(raster_method="pallas", max_dup=ring_dup,
                               tile_capacity=ring_k, dup_overscan=1)
    bg0 = torch.zeros(3, device=dev)
    gts = {k: [plain_render(rows, c, street_cfg, bg0).cpu() for c in cams]
           for k, (rows, cams) in scenes.items()}
    gen = torch.Generator().manual_seed(17)
    bgs = {k: torch.rand((PAR_STEPS, N_VIEWS, 3), generator=gen)
           for k in scenes}
    extent = {k: scene_extent(cams) for k, (_, cams) in scenes.items()}
    inputs = root / "inputs.pt"
    torch.save({"scenes": {"street": (N_ROWS, N_VIEWS, WIDTH, HEIGHT),
                           "reduced": (PAR_REDUCED_N, N_VIEWS,
                                       PAR_REDUCED_W, PAR_REDUCED_H)},
                "gts": gts, "bgs": bgs, "extent": extent}, inputs)
    sizing = {"exact_extra_2": e2, "exact_extra_4": e4,
              "ring_max_dup": ring_dup, "ring_tile_capacity": ring_k}
    setup_s = time.perf_counter() - t0

    one = [[s] for s in range(PAR_STEPS)]
    pair = [[0, 1]] * PAR_STEPS
    four = [list(range(N_VIEWS))] * PAR_STEPS
    worlds = {
        "gloo_2": (2, "gloo", [
            ("tiles_padded", "par_render", {"cfg": raster_config(padded)}),
            ("tiles_exact", "par_render", {"cfg": raster_config(exact2)}),
            ("tp_street", "par_steps", dict(
                kind="tp", pipe=exact2, key="street", views=one, n_data=1,
                n_tile=2)),
            ("dp", "par_steps", dict(kind="dp", pipe=street_pipe,
                                     key="street", views=pair, n_data=2,
                                     n_tile=1)),
            ("ring", "par_render", {"cfg": raster_config(ring_pipe),
                                    "ring": True}),
            ("ring_step", "par_steps", dict(
                kind="ring", pipe=ring_pipe, key="street", views=one,
                n_data=1, n_tile=2)),
            ("dryrun", "dryrun", {"project": str(root / "dryrun")})]),
        "nccl_1": (1, "nccl" if dev.type == "cuda" else "gloo", [
            ("dp", "par_steps", dict(kind="dp", pipe=street_pipe,
                                     key="street", views=pair, n_data=1,
                                     n_tile=1, repeat=2)),
            ("tiles_padded", "par_render", {"cfg": raster_config(padded)}),
            ("dp_reduced_padded", "par_steps", dict(
                kind="dp", pipe=padded, key="reduced", views=four,
                n_data=1, n_tile=1)),
            ("dp_reduced_exact", "par_steps", dict(
                kind="dp", pipe=exact4, key="reduced", views=four,
                n_data=1, n_tile=1))]),
        "gloo_4": (4, "gloo", [
            ("tp_reduced_padded", "par_steps", dict(
                kind="tp", pipe=padded, key="reduced", views=four, n_data=2,
                n_tile=2)),
            ("tp_reduced_exact", "par_steps", dict(
                kind="tp", pipe=exact4, key="reduced", views=four, n_data=2,
                n_tile=2))])}
    expect = {"tiles_padded": "padded", "tiles_exact": "exact",
              "tp_street": "exact", "dp": "exact", "ring": "ring",
              "ring_step": "ring", "dryrun": "all",
              "dp_reduced_padded": "padded", "dp_reduced_exact": "exact",
              "tp_reduced_padded": "padded", "tp_reduced_exact": "exact"}
    res, world_s = {}, {}
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    for wname, (world, backend, cases) in worlds.items():
        s0 = time.perf_counter()
        res[wname] = run_world(
            par_rank, world, root / wname, backend,
            args=({"device": dev.type, "inputs": str(inputs),
                   "cases": cases},), timeout_s=PAR_TIMEOUT)
        world_s[wname] = time.perf_counter() - s0
    launches = {k: 0 for k in PAR_KERNELS["all"]}
    runs = {}
    for wname, ranks in res.items():
        world, backend, _ = worlds[wname]
        for case in ranks[0]:
            per = [r[case] for r in ranks]
            for i, rec in enumerate(per):
                for k in PAR_KERNELS[expect[case]]:
                    if rec["launches"][k] == 0:
                        raise AssertionError(f"parallel {wname} {case} rank "
                                             f"{i}: never launched {k}")
                for k in launches:
                    launches[k] += rec["launches"][k]
            if "checksum" in per[0] and case not in ("ring", "ring_step"):
                if any(r["checksum"] != per[0]["checksum"] for r in per):
                    raise AssertionError(f"parallel {wname} {case}: the "
                                         "ranks' replicated results differ")
            runs[f"{wname}/{case}"] = {
                "world": world, "backend": backend,
                "seconds": [r["seconds"] for r in per],
                "ms_median": [r.get("ms_median") for r in per],
                "ms": [r.get("ms") for r in per],
                "transport": [r["transport"] for r in per],
                "peak_bytes": [r["peak_bytes"] for r in per],
                "peak_bytes_sum": sum(r["peak_bytes"] for r in per),
                "launches": [{k: v for k, v in r["launches"].items() if v}
                             for r in per]}
    workers_s = time.perf_counter() - t0 - setup_s

    # ---- the serial path in this process, and the checks ----------------
    checks = {}
    g2, g1, g4 = res["gloo_2"], res["nccl_1"], res["gloo_4"]
    rows, cams = scenes["street"]

    def serial_render(cfg):
        leaves = [r.detach().requires_grad_(True) for r in rows]
        out = rasterize(*leaves, cams[0], 3, bg0, cfg)
        torch.mean(out["render"] ** 2).backward()
        img = torch.cat([out["render"], out["depth"], out["alpha"][None]])
        return img.detach(), [x.grad for x in leaves], out

    for case, cfg in (("tiles_padded", raster_config(padded)),
                      ("tiles_exact", raster_config(exact2)),
                      ("ring", raster_config(ring_pipe))):
        img, grads, out = serial_render(cfg)
        got = g2[0][case]
        got_grads = ([torch.cat([r[case]["grads"][i] for r in g2])
                      for i in range(5)] if case == "ring"
                     else got["grads"])
        checks[case] = {"image": image_within(case, got["image"], img),
                        "grads": grads_within(case, got_grads, grads),
                        "overflow": got["overflow"],
                        "serial_overflow": {
                            k: int(out[k]) for k in ("tile_overflow",
                                                     "dup_overflow")}}
        if case == "tiles_padded":
            checks[case]["nccl_1"] = {
                "image": image_within("nccl tiles", g1[0][case]["image"],
                                      img),
                "grads": grads_within("nccl tiles", g1[0][case]["grads"],
                                      grads)}
        if case == "ring" and (got["overflow"]["pair_overflow"]
                               or got["overflow"]["tile_overflow"]
                               or got["overflow"]["dup_overflow"]):
            raise AssertionError(f"parallel ring: overflow {got['overflow']}")
        del img, grads, out

    opt = OptimizationConfig()

    def serial_steps(pipe, key, views):
        srows, scams = scenes[key]
        params = start_params(srows, 1, dev)
        n = params.xyz.shape[0]
        state = init_state(params, torch.ones(n, dtype=torch.bool,
                                              device=dev), len(scams))
        step = make_train_step(_meta(n), opt, pipe, extent[key],
                               sh_degree_schedule=False,
                               random_background=False)
        batches = camera_batches(scams, [g.to(dev) for g in gts[key]], dev)
        losses = []
        for s in range(PAR_STEPS):
            v = views[s][0]
            state, aux = step(state, batches[v],
                              bg=bgs[key][s, v].to(dev))
            losses.append(float(aux["loss"]))
            if int(aux.get("update_skipped", 0)):
                raise AssertionError(f"serial {key} step skipped")
        return state_record(state), losses

    def losses_of(rec):
        return [a["loss"] for a in rec["aux"]]

    for case, pipe in (("tp_street", exact2), ("ring_step", ring_pipe)):
        want, want_losses = serial_steps(pipe, "street", one)
        per = [r[case] for r in g2]
        if case == "ring_step":
            got = {**per[0]["state"],
                   "params": {k: torch.cat([r["state"]["params"][k]
                                            for r in per])
                              for k in per[0]["state"]["params"]},
                   **{k: torch.cat([r["state"][k] for r in per])
                      for k in ("grad_accum", "denom", "max_radii2d")}}
        else:
            got = per[0]["state"]
        checks[case] = states_within(case, got, want, opt, extent["street"],
                                     losses_of(per[0]), want_losses)
        checks[case]["aux"] = per[0]["aux"]
        if any(a.get("update_skipped", 0) or a.get("tile_overflow", 0)
               for a in per[0]["aux"]):
            raise AssertionError(f"parallel {case}: {per[0]['aux']}")
        del want
    for case, got, want, key in (
            ("dp", g2[0]["dp"], g1[0]["dp"], "street"),
            ("tp_reduced_padded", g4[0]["tp_reduced_padded"],
             g1[0]["dp_reduced_padded"], "reduced"),
            ("tp_reduced_exact", g4[0]["tp_reduced_exact"],
             g1[0]["dp_reduced_exact"], "reduced")):
        checks[case] = states_within(case, got["state"], want["state"], opt,
                                     extent[key], losses_of(got),
                                     losses_of(want))
        checks[case]["aux"] = got["aux"]
        if any(a.get("update_skipped", 0) for a in got["aux"]):
            raise AssertionError(f"parallel {case}: {got['aux']}")
    checks["dp"]["nccl_1_bit_identical_rerun"] = g1[0]["dp"][
        "bit_identical_rerun"]
    dry = g2[0]["dryrun"]["record"]
    for name in ("dp", "tp_padded", "tp_exact", "ring_step"):
        if not math.isfinite(dry[name]["loss"]):
            raise AssertionError(f"dry run {name}: loss {dry[name]}")
    if not dry["full_train"]["merged"] or not all(
            dry[k]["finite"] for k in ("tiles_padded", "tiles_exact", "ring",
                                       "hierarchy_cut", "post")):
        raise AssertionError(f"dry run: {dry}")
    checks["dryrun"] = {k: v for k, v in dry.items() if k != "transport"}
    checks["k4_rank_vs_whole"] = [r["tiles_exact"]["k4_rank_vs_whole"]
                                  for r in g2]

    # The first kernel calls each rank held against the plain versions.
    held = {"K1 tile0 > 0": g2[1]["tiles_padded"]["held"]["fwd"],
            "K2 tile0 > 0": g2[1]["tiles_padded"]["held"]["bwd"],
            "K1 t_mod, per-tile bg": [r["tp_reduced_padded"]["held"]["fwd"]
                                      for r in g4],
            "K2 t_mod, per-tile bg": [r["tp_reduced_padded"]["held"]["bwd"]
                                      for r in g4],
            "K3 order": [r["tiles_exact"]["held"]["fwd"] for r in g2],
            "K4 order": [r["tiles_exact"]["held"]["bwd"] for r in g2],
            "K3 t_mod": [r["tp_reduced_exact"]["held"]["fwd"] for r in g4]
            + [r["tp_street"]["held"]["fwd"] for r in g2],
            "K4 t_mod": [r["tp_reduced_exact"]["held"]["bwd"] for r in g4]
            + [r["tp_street"]["held"]["bwd"] for r in g2]}
    sync(dev)
    emit({"phase": "parallel", "seconds": time.perf_counter() - t0,
          "setup_seconds": setup_s, "worlds_seconds": world_s,
          "checks_seconds": time.perf_counter() - t0 - setup_s - workers_s,
          "note": "W ranks share one card: times are not multi-card "
                  "scaling",
          "reduced": {"tp (2 x 2) and its dp reference": {
              "rows": PAR_REDUCED_N, "width": PAR_REDUCED_W,
              "height": PAR_REDUCED_H, "from": "1M rows at 1920x1088"}},
          "sizing": sizing, "runs": runs, "checks": checks,
          "held": held, "launches": launches})
    return {"launches": launches, "held": held}


# ---- viewer_app: the web viewer on the street rows -------------------------
# Frames of VIEW_W x VIEW_H, VIEW_TIMED timed requests (the median) after one
# warm-up per source; the --budget cut's node count; the JPEG bar; the
# frame time a 30 frames/s viewer needs.
VIEW_W, VIEW_H, VIEW_TIMED = 1920, 1088, 5
VIEW_BUDGET = 300_000
VIEW_PSNR_MIN = 30.0
VIEW_FRAME_MS = 1000.0 / 30.0
VIEW_LSB = 1                     # a frame pixel may differ by one level


def fly_state_of(cam):
    """A FlyState at a scene camera's centre looking along its optical axis
    (yaw and pitch of its forward row, world up +z) with its fov."""
    from street_sparse_3dgs_tpu_torch.viewer.app import FlyState
    import numpy as np
    w2c = cam.viewmatrix.cpu().numpy().astype(np.float64)
    fwd = w2c[2, :3] / np.linalg.norm(w2c[2, :3])
    return FlyState(pos=cam.campos.cpu().numpy().astype(np.float64),
                    yaw=math.atan2(fwd[1], fwd[0]),
                    pitch=math.asin(float(np.clip(fwd[2], -1.0, 1.0))),
                    fovx_deg=math.degrees(2 * math.atan(float(
                        cam.tan_fovx))))


def http_frame(port: int, body: dict) -> tuple:
    """POST /frame: (ms from send to the last byte, headers, JPEG bytes)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/frame", json.dumps(body).encode())
        res = conn.getresponse()
        data = res.read()
        ms = (time.perf_counter() - t0) * 1e3
        if res.status != 200:
            raise AssertionError(f"/frame answered {res.status}")
        return ms, {k.lower(): v for k, v in res.getheaders()}, data
    finally:
        conn.close()


class StageClock:
    """Times the viewer's stages from inside while its server answers:
    wraps ``module.name`` so each outermost call (one wrapped function
    calling another counts once, as the outer one) adds its wall ms (the
    card synchronised before and after) to ``ms[key]``, and with ``device``
    its CUDA-event ms to ``ms[key + "_device"]``."""

    def __init__(self):
        self.ms: dict = {}
        self._undo: list = []
        self._depth = 0

    def wrap(self, module, name: str, key: str, device: bool = False):
        fn = getattr(module, name)

        def timed(*args, **kw):
            if self._depth:
                return fn(*args, **kw)
            self._depth += 1
            try:
                return outer(*args, **kw)
            finally:
                self._depth -= 1

        def outer(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if device:
                e0, e1 = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                e0.record()
            out = fn(*args, **kw)
            if device:
                e1.record()
            torch.cuda.synchronize()
            self.ms[key] = self.ms.get(key, 0.0) + (
                time.perf_counter() - t0) * 1e3
            if device:
                self.ms[key + "_device"] = self.ms.get(
                    key + "_device", 0.0) + e0.elapsed_time(e1)
            return out

        setattr(module, name, timed)
        self._undo.append((module, name, fn))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for module, name, fn in reversed(self._undo):
            setattr(module, name, fn)
        return False


@contextlib.contextmanager
def plain_kernels():
    """K5 and K1 replaced by their plain versions (the reference render)."""
    from street_sparse_3dgs_tpu_torch.ops import binning
    from street_sparse_3dgs_tpu_torch.ops import cuda_blend as cb
    saved = binning.slab_gather, cb.blend_padded
    binning.slab_gather = binning.slab_gather_plain
    cb.blend_padded = cb.blend_padded_plain
    try:
        yield
    finally:
        binning.slab_gather, cb.blend_padded = saved


def psnr_u8(a, b) -> float:
    import numpy as np
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)


def viewer_app_phase(dev, scene, hier_path: Path) -> dict:
    """``viewer/app.py`` on the card: ``ViewerApp`` on port 0 in this
    process over the street rows' hierarchy (phase 5's ``.hier.npz``) and
    the rows as ``point_cloud.ply``; a client asks for VIEW_W x VIEW_H
    frames from view 0's pose at each tau of TAUS, one ``--budget`` cut and
    the leaf source.  Each source: one warm-up request whose K5 and K1 calls
    are held against the plain versions and whose frame is held against
    the render of the same cut through the plain versions (VIEW_LSB, at
    all but FLIP_SHARE of the pixels), then VIEW_TIMED timed requests that
    must give the same frame; the JPEG decoded by the port's decoder
    (PSNR >= VIEW_PSNR_MIN against the frame) and ``x-status`` against
    ``last_overflow``.  Launches are counted over every request."""
    import numpy as np
    from street_sparse_3dgs_tpu_torch import native
    from street_sparse_3dgs_tpu_torch.data import jpeg
    from street_sparse_3dgs_tpu_torch.data.ply import save_gaussian_ply
    from street_sparse_3dgs_tpu_torch.hierarchy import render as hrender
    from street_sparse_3dgs_tpu_torch.hierarchy import structure
    from street_sparse_3dgs_tpu_torch.models.gaussians import GaussianParams
    from street_sparse_3dgs_tpu_torch.ops import binning
    from street_sparse_3dgs_tpu_torch.ops import cuda_blend as cb
    from street_sparse_3dgs_tpu_torch.ops import rasterize as rz
    from street_sparse_3dgs_tpu_torch.viewer import app as va

    t0 = time.perf_counter()
    leaf_dir = ROOT / "build" / "smoke" / "viewer_leaf"
    leaf_dir.mkdir(parents=True, exist_ok=True)
    save_gaussian_ply(leaf_dir / "point_cloud.ply", GaussianParams(
        xyz=scene.means3d, features_dc=scene.sh_coeffs[:, :1],
        features_rest=scene.sh_coeffs[:, 1:],
        log_scales=torch.log(scene.scales), quats=scene.quats,
        opacity_raw=torch.logit(scene.opacities)[:, None]))
    write_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    hier_src = va.SceneSource(hier_path, device=dev)
    leaf_src = va.SceneSource(leaf_dir, device=dev)
    load_s = time.perf_counter() - t1
    state = fly_state_of(scene.cameras[0])
    frame_body = {"pos": [float(v) for v in state.pos], "yaw": state.yaw,
                  "pitch": state.pitch, "fov": state.fovx_deg,
                  "width": VIEW_W, "height": VIEW_H, "scaling": 1.0}
    requests = ([(f"tau {tau:g}", hier_src, 0, tau) for tau in TAUS]
                + [(f"budget {VIEW_BUDGET}", hier_src, VIEW_BUDGET, 6.0),
                   ("leaf", leaf_src, 0, 6.0)])
    app = va.ViewerApp(hier_src, port=0)
    app.serve_background()
    frames: dict = {}
    overflow: dict = {}

    def keep(src):
        fn = src.render

        def render(*a, **kw):
            frame = fn(*a, **kw)
            frames["last"], overflow["last"] = frame, src.last_overflow
            return frame
        return render

    for src in (hier_src, leaf_src):
        src.render = keep(src)
    torch.cuda.reset_peak_memory_stats()
    native.reset_launches()
    runs, held, calls = [], {}, {}
    try:
        for name, src, budget, tau in requests:
            app.source, src.point_budget = src, budget
            body = dict(frame_body, tau=tau)
            with Recorder(binning, "slab_gather") as k5, \
                    Recorder(cb, "blend_padded") as k1:
                http_frame(app.port, body)
            ref_frame = frames["last"]
            held[name] = {
                "K5": [bool(torch.equal(o, binning.slab_gather_plain(*a)))
                       for a, o in k5.calls],
                "K1": [compare_blend(o, cb.blend_padded_plain(*a))
                       for a, o in k1.calls]}
            if not all(held[name]["K5"]):
                raise AssertionError(f"viewer {name}: K5 differs from plain")
            for cmp in held[name]["K1"]:
                check_blend(f"viewer {name} K1", cmp, strict=False)
            if not k1.calls or not k5.calls:
                raise AssertionError(f"viewer {name}: no K1/K5 call")
            if not calls:           # the first request's, timed in phase 18
                calls["slab_gather"], calls["blend_padded"] = (k5.calls[0],
                                                               k1.calls[0])
            state_r = va.FlyState(pos=np.asarray(body["pos"]),
                                  yaw=body["yaw"], pitch=body["pitch"],
                                  fovx_deg=body["fov"])
            with plain_kernels():
                plain = src.render(state_r, VIEW_W, VIEW_H, tau=tau)
            diff = np.abs(ref_frame.astype(np.int16) - plain.astype(np.int16))
            over = int((diff.max(axis=2) > VIEW_LSB).sum())
            if over > FLIP_SHARE * VIEW_W * VIEW_H:
                raise AssertionError(f"viewer {name}: {over} pixels over "
                                     f"{VIEW_LSB} level(s) off the plain "
                                     "render")
            timed = []
            for _ in range(VIEW_TIMED):
                with StageClock() as clock:
                    clock.wrap(structure, "select_cut", "cut_ms")
                    clock.wrap(structure, "budget_limit", "cut_ms")
                    clock.wrap(hrender, "render_cut_compact", "render_ms",
                               device=True)
                    clock.wrap(rz, "rasterize", "render_ms", device=True)
                    clock.wrap(va, "encode_jpeg", "encode_ms")
                    ms, headers, data = http_frame(app.port, body)
                frame = frames["last"]
                if not np.array_equal(frame, ref_frame):
                    raise AssertionError(f"viewer {name}: frame not "
                                         "repeatable")
                if headers.get("content-type") != "image/jpeg" or \
                        data[:3] != b"\xff\xd8\xff":
                    raise AssertionError(f"viewer {name}: not a JPEG reply")
                want = f"{VIEW_W}x{VIEW_H}" + (
                    f" overflow:{overflow['last']}" if overflow["last"]
                    else "")
                if headers.get("x-status") != want:
                    raise AssertionError(f"viewer {name}: x-status "
                                         f"{headers.get('x-status')!r}, "
                                         f"want {want!r}")
                timed.append({"request_ms": ms, **clock.ms})
            decoded = jpeg.decode_jpeg(data, f"viewer {name} frame")
            psnr = psnr_u8(decoded, frame)
            if decoded.shape != frame.shape or psnr < VIEW_PSNR_MIN:
                raise AssertionError(f"viewer {name}: JPEG PSNR {psnr:.2f} "
                                     f"dB < {VIEW_PSNR_MIN}")

            def med(key):
                return statistics.median(t.get(key, 0.0) for t in timed)

            rec = {"request": name, "request_ms": med("request_ms"),
                   "cut_ms": med("cut_ms"), "render_ms": med("render_ms"),
                   "render_device_ms": med("render_ms_device"),
                   "encode_ms": med("encode_ms"),
                   "jpeg_bytes": len(data), "jpeg_psnr_db": psnr,
                   "overflow": overflow["last"],
                   "x_status": headers.get("x-status"),
                   "pixels_over_lsb_vs_plain": over,
                   "max_level_diff_vs_plain": int(diff.max()),
                   "frame_mean": float(frame.mean())}
            rec["http_and_rest_ms"] = (rec["request_ms"] - rec["cut_ms"]
                                       - rec["render_ms"] - rec["encode_ms"])
            if budget:
                rec["budget"] = budget
            runs.append(rec)
    finally:
        app.close()
    launches = dict(native.LAUNCHES)
    for key in ("slab_gather", "blend_padded"):
        if launches[key] == 0:
            raise AssertionError(f"viewer_app never launched {key}")
    rec = {"phase": "viewer_app", "seconds": time.perf_counter() - t0,
           "width": VIEW_W, "height": VIEW_H, "nodes": hier_src.n_points,
           "leaf_rows": leaf_src.n_points, "write_ply_seconds": write_s,
           "load_seconds": load_s, "timed_requests": VIEW_TIMED,
           "frame_budget_ms": VIEW_FRAME_MS, "psnr_bar_db": VIEW_PSNR_MIN,
           "lsb_bar": f"{VIEW_LSB} level at all but {FLIP_SHARE} of the "
                      "pixels",
           "requests": runs, "held": held, "launches": launches,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(rec)
    return {**rec, "calls": calls}


# ---- preprocess: the host pipeline on a synthetic street project ----------
# calibration.py's defaults: 8 cube faces of 2048 px; 200 recordings 5 m
# apart along about 1 km; the SfM cloud, its tracks into the nearest
# recordings' faces; LiDAR tiles in LAZ point format 3; the Depth-Anything
# vitl faces at target 518; the mesh of the CTM export.
PRE_RECORDINGS, PRE_SPACING_M, PRE_FACE = 200, 5.0, 2048
PRE_JPEG_FACES, PRE_JPEG_QUALITY, PRE_JPEG_PSNR_MIN = 64, 95, 30.0
PRE_SFM_POINTS, PRE_TRACK = 1_000_000, 2
PRE_LAZ_TILES, PRE_LAZ_POINTS = 4, 2_500_000
PRE_DEPTH_MAPS = 64
PRE_MONO_IMAGES, PRE_MONO_TARGET = 16, 518
PRE_MONO_CHECK_LAYERS, PRE_MONO_RTOL = 4, 1e-4
PRE_MASK_FACES = 64
PRE_MESH_TRIS = 2_000_000
PRE_WORKERS = 8


def street_face(base, k: int):
    """Face k: the shared texture shifted and its channels rotated."""
    import numpy as np
    return np.ascontiguousarray(np.roll(
        np.roll(base, 37 * k, axis=0), 91 * k, axis=1)[..., [k % 3,
                                                             (k + 1) % 3,
                                                             (k + 2) % 3]])


def sfm_tracks(images, cams, n: int, rng):
    """``n`` SfM points over the recordings' street (z up, facades at y
    +-12 m) observed by the face of each of their PRE_TRACK nearest
    recordings that sees them most squarely: (ColmapPoints with tracks,
    images with their xys and point3D_ids)."""
    import numpy as np
    from street_sparse_3dgs_tpu_torch.data import colmap
    keys = sorted(images)
    qv = np.stack([images[k].qvec for k in keys])
    tv = np.stack([images[k].tvec for k in keys])
    rot = np.stack([colmap.qvec2rotmat(q) for q in qv])      # [I, 3, 3]
    centre = -np.einsum("kji,kj->ki", rot, tv)
    n_face = len(cams)
    rec_x = centre[::n_face, 0]
    x = rng.uniform(rec_x.min() - 10, rec_x.max() + 10, n)
    side = rng.integers(0, 3, n)
    y = np.where(side == 0, rng.uniform(-12, 12, n),
                 np.where(side == 1, 12.0, -12.0) + rng.normal(0, 0.2, n))
    z = np.where(side == 0, rng.normal(0, 0.05, n), rng.uniform(0, 14, n))
    xyz = np.stack([x, y, z], 1)
    nearest = np.clip(np.round((x - rec_x[0]) / PRE_SPACING_M), 0,
                      len(rec_x) - 1).astype(np.int64)
    # The nearest recording, then the next on the point's side, then the
    # one on the other side.
    away = np.where(x >= rec_x[nearest], 1, -1)
    obs_img, obs_pt, obs_xy = [], [], []
    for j in range(PRE_TRACK):
        rec = np.clip(nearest + (0, 1, -1)[j] * away, 0, len(rec_x) - 1)
        faces = rec[:, None] * n_face + np.arange(n_face)[None, :]
        cam_pts = np.einsum("nfij,nj->nfi", rot[faces],
                            xyz) + tv[faces]                   # [n, F, 3]
        zc = cam_pts[..., 2]
        best = np.argmax(zc / np.linalg.norm(cam_pts, axis=-1), axis=1)
        img = faces[np.arange(n), best]
        pc = cam_pts[np.arange(n), best]
        f, c = PRE_FACE / 2.0, PRE_FACE / 2.0
        xy = np.stack([f * pc[:, 0] / pc[:, 2] + c,
                       f * pc[:, 1] / pc[:, 2] + c], 1)
        obs_img.append(img)
        obs_pt.append(np.arange(n))
        obs_xy.append(xy)
    obs_img = np.concatenate(obs_img)
    obs_pt = np.concatenate(obs_pt)
    obs_xy = np.concatenate(obs_xy)
    order = np.argsort(obs_img, kind="stable")
    counts = np.bincount(obs_img, minlength=len(keys))
    first = np.cumsum(counts) - counts
    slot = np.empty_like(obs_img)
    slot[order] = np.arange(len(order)) - np.repeat(first, counts)
    ids = np.arange(1, n + 1, dtype=np.int64)
    out = {}
    for i, k in enumerate(keys):
        sel = order[first[i]:first[i] + counts[i]]
        im = images[k]
        out[k] = colmap.ColmapImage(im.id, im.qvec, im.tvec, im.camera_id,
                                    im.name, obs_xy[sel], ids[obs_pt[sel]])
    by_pt = np.argsort(obs_pt, kind="stable")
    t_img = np.asarray(keys, np.int32)[obs_img[by_pt]]
    cuts = np.arange(PRE_TRACK, n * PRE_TRACK, PRE_TRACK)
    pts = colmap.ColmapPoints(
        xyz=xyz, rgb=rng.integers(0, 256, (n, 3)).astype(np.uint8),
        error=rng.uniform(0.2, 1.5, n), ids=ids,
        track_image_ids=np.split(t_img, cuts),
        track_point2d_idxs=np.split(slot[by_pt].astype(np.int32), cuts))
    return pts, out


def cyclomedia_depth(depth_mm):
    """Depth in millimetres -> the renderer's BGR encoding (units < 2^14,
    a precision exponent of 2 per step), black where depth is 0."""
    import numpy as np
    units = depth_mm.astype(np.int64)
    prec = np.zeros_like(units)
    for _ in range(4):
        big = units >= (1 << 14)
        units = np.where(big, units >> 2, units)
        prec = np.where(big, prec + 2, prec)
    r = ((prec >> 1) << 6) | (units >> 8)
    g = units & 255
    b = (depth_mm > 0).astype(np.int64)
    return np.stack([b, g, r], -1).astype(np.uint8)


def preprocess_phase(dev, card: str) -> dict:
    """The preprocessing slice on a synthetic street project at the JAX
    code's default sizes (see the PRE_* constants): calibration to COLMAP
    in eval mode, cube faces through the port's JPEG encoder and decoder,
    SfM points with tracks, LAZ tiles through the port's codec, virtual
    depth cameras, ``make_chunks`` with the LiDAR merge, Cyclomedia depth
    maps through ``depth_decode`` and ``make_depth_scale``, Depth-Anything
    vitl on the card through ``mono_depth.generate_depth`` (random weights
    saved in the original repo's naming; a 4-layer vitl-width model card
    against CPU), ``mask_images.process_images`` with precomputed
    detections, and the CTM export of a mesh through the native writer
    (against the plain writer, byte for byte).  Every step is timed."""
    import os
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    from street_sparse_3dgs_tpu_torch.data import colmap, jpeg, png
    from street_sparse_3dgs_tpu_torch.native import ctm
    from street_sparse_3dgs_tpu_torch.preprocess import (calibration, chunk,
                                                         depth_anything,
                                                         depth_decode,
                                                         depth_pipeline,
                                                         depth_scale, laz,
                                                         mask_images,
                                                         mono_depth)

    t_all = time.perf_counter()
    root = ROOT / "build" / "smoke" / "preprocess"
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(0)
    steps: dict = {}
    out: dict = {"phase": "preprocess", "card": card}

    @contextlib.contextmanager
    def step(name):
        t0 = time.perf_counter()
        yield
        steps[name] = time.perf_counter() - t0

    pool = ThreadPoolExecutor(PRE_WORKERS)
    calib = root / "camera_calibration"
    sparse = calib / "aligned" / "sparse" / "0"
    extras = calib / "extras"
    # 1. calibration -> COLMAP (eval mode), 8 faces of PRE_FACE px.
    with step("calibration"):
        recs = [{"ImageId": f"{i:05d}", "RecordedAt": i,
                 "X": 120000.0 + PRE_SPACING_M * i,
                 "Y": 480000.0 + 3.0 * math.sin(i / 25.0),
                 "Height": 2.5, "VehicleDirection": 0.0, "Yaw": 0.0}
                for i in range(PRE_RECORDINGS)]
        details = {"RecordingProperties": recs}
        extras.mkdir(parents=True, exist_ok=True)
        (extras / "recording_details_train.json").write_text(
            json.dumps(details))
        info = calibration.generate_colmap_from_calibration(
            details, sparse, cube_face_size=PRE_FACE, eval_mode=True)
        cams, images, _ = colmap.read_model(sparse)
    n_views = len(images)
    if n_views != PRE_RECORDINGS * len(calibration.DEFAULT_FACES) or \
            any(c.width != PRE_FACE for c in cams.values()):
        raise AssertionError(f"calibration: {n_views} views")
    out["calibration"] = {**info, "views": n_views, "cameras": len(cams)}

    # 2. cube faces as JPEG through the port's encoder, decoded back.
    y, x = np.mgrid[0:PRE_FACE, 0:PRE_FACE].astype(np.float32)
    base = np.stack([128 + 70 * np.sin(x / 37.0) * np.cos(y / 53.0),
                     128 + 60 * np.cos((x + y) / 71.0),
                     128 + 50 * np.sin(x / 19.0 + y / 23.0)], -1)
    base += rng.normal(0, 6, base.shape).astype(np.float32)
    base = np.clip(base, 0, 255).astype(np.uint8)
    del x, y
    names = [images[k].name for k in sorted(images)][:PRE_JPEG_FACES]
    faces_dir = root / "inputs" / "images"
    for name in names:
        (faces_dir / name).parent.mkdir(parents=True, exist_ok=True)
    faces = [street_face(base, k) for k in range(PRE_JPEG_FACES)]
    with step("jpeg_encode"):
        list(pool.map(lambda k: jpeg.write_jpeg(
            faces_dir / names[k], faces[k], PRE_JPEG_QUALITY),
            range(PRE_JPEG_FACES)))
    sizes = [(faces_dir / n).stat().st_size for n in names]
    with step("jpeg_decode"):
        decoded = list(pool.map(lambda n: jpeg.read_jpeg(faces_dir / n),
                                names))
    psnr = min(psnr_u8(d, f) for d, f in zip(decoded, faces))
    if psnr < PRE_JPEG_PSNR_MIN:
        raise AssertionError(f"preprocess: JPEG round trip {psnr:.2f} dB")
    mp = PRE_JPEG_FACES * PRE_FACE * PRE_FACE / 1e6
    out["jpeg"] = {"faces": PRE_JPEG_FACES, "quality": PRE_JPEG_QUALITY,
                   "megapixels": mp, "workers": PRE_WORKERS,
                   "encode_mp_s": mp / steps["jpeg_encode"],
                   "decode_mp_s": mp / steps["jpeg_decode"],
                   "bytes_per_face": float(np.mean(sizes)),
                   "min_psnr_db": psnr}
    del decoded, faces

    # 3. SfM points with tracks into their nearest views.
    with step("sfm_points"):
        pts, images = sfm_tracks(images, cams, PRE_SFM_POINTS, rng)
        colmap.write_model(cams, images, pts, sparse)
    with step("sfm_read_back"):
        _, images_back, pts_back = colmap.read_model(sparse)
    if not np.array_equal(pts_back.ids, pts.ids) or \
            sum(len(t) for t in pts_back.track_image_ids) != \
            PRE_TRACK * PRE_SFM_POINTS:
        raise AssertionError("preprocess: points3D round trip")
    out["sfm"] = {"points": PRE_SFM_POINTS, "track": PRE_TRACK,
                  "observations_per_view": float(np.mean(
                      [len(im.xys) for im in images_back.values()]))}
    del images_back, pts_back

    # 4. LiDAR tiles: LAZ point format 3 through the port's codec.
    lidar = root / "lidar"
    lidar.mkdir(parents=True)
    x_lo, x_hi = pts.xyz[:, 0].min(), pts.xyz[:, 0].max()
    tiles = []
    for t in range(PRE_LAZ_TILES):
        lo = x_lo + (x_hi - x_lo) * t / PRE_LAZ_TILES
        hi = x_lo + (x_hi - x_lo) * (t + 1) / PRE_LAZ_TILES
        xyz = np.stack([rng.uniform(lo, hi, PRE_LAZ_POINTS),
                        rng.uniform(-14, 14, PRE_LAZ_POINTS),
                        rng.uniform(0, 15, PRE_LAZ_POINTS)], 1)
        tiles.append((lidar / f"tile_{t}.laz", xyz,
                      rng.integers(0, 256, (PRE_LAZ_POINTS, 3)).astype(
                          np.uint8),
                      np.sort(rng.uniform(0, 1e5, PRE_LAZ_POINTS))))
    with step("laz_write"):
        list(pool.map(lambda tl: laz.write_points(tl[0], tl[1], rgb=tl[2],
                                                  gps_time=tl[3]), tiles))
    with step("laz_read"):
        back = list(pool.map(lambda tl: laz.read_points(tl[0]), tiles))
    for (path, xyz, rgb, gps), got in zip(tiles, back):
        if got["point_format"] != 3 or \
                np.abs(got["x"] - xyz[:, 0]).max() > 0.0006 or \
                not np.array_equal(got["red"], rgb[:, 0].astype(
                    np.uint16) * 257) or \
                not np.array_equal(got["gps_time"], gps):
            raise AssertionError(f"preprocess: {path.name} round trip")
    n_laz = PRE_LAZ_TILES * PRE_LAZ_POINTS
    out["laz"] = {"tiles": PRE_LAZ_TILES, "points": n_laz,
                  "bytes": sum(t[0].stat().st_size for t in tiles),
                  "write_mpts_s": n_laz / 1e6 / steps["laz_write"],
                  "read_mpts_s": n_laz / 1e6 / steps["laz_read"],
                  "workers": PRE_WORKERS}
    del tiles, back

    # 5. virtual depth cameras and the vis2mesh cameras (depth_pipeline's
    # local steps), before chunking so that chunks take their depth views.
    with step("virtual_cams"):
        report = depth_pipeline.generate_depths(root)
    depth_views = colmap.read_images_binary(sparse / "images_depths.bin")
    if len(depth_views) == 0 or not (extras / "vis2mesh_cams.json").exists():
        raise AssertionError(f"preprocess: virtual cameras {report}")
    out["virtual_cams"] = {"depth_views": len(depth_views),
                           "ran": [r[0] for r in report["ran"]]}

    # 6. chunking with the LiDAR merge.
    with step("make_chunks"):
        names_c = chunk.make_chunks(
            sparse, root / "chunks",
            chunk.ChunkConfig(chunk_size=100.0, lidar_initialisation=True),
            lidar_dir=lidar)
    if not names_c:
        raise AssertionError("preprocess: no chunk written")
    _, c_images, c_pts = colmap.read_model(root / "chunks" / names_c[0]
                                           / "sparse" / "0")
    if int(c_pts.ids.max()) <= PRE_SFM_POINTS:
        raise AssertionError("preprocess: chunk 0 has no LiDAR rows")
    out["chunks"] = {"chunks": len(names_c), "chunk_size": 100.0,
                     "lidar_downsample_density":
                         chunk.ChunkConfig().lidar_downsample_density,
                     "chunk0_views": len(c_images),
                     "chunk0_points": int(c_pts.xyz.shape[0])}
    del c_images, c_pts

    # 7. Cyclomedia depth maps -> 16-bit inverse depth -> depth scales.
    stems = [images[k].name.rsplit(".", 1)[0]
             for k in sorted(images)][:PRE_DEPTH_MAPS]
    yy = np.linspace(0, 1, PRE_FACE)[:, None]
    encoded = root / "depth_encoded"
    depths = root / "depths"
    for stem in stems:
        (encoded / stem).parent.mkdir(parents=True, exist_ok=True)

    def write_encoded(k: int) -> None:
        mm = (2000 + 90000 * (1 - yy) * (0.5 + 0.5 * np.cos(
            np.linspace(0, 3, PRE_FACE)[None, :] + k))).astype(
            np.int64)
        mm[:PRE_FACE // 8] = 0                       # sky
        # The renderer's files hold B, G, R; depth_decode reads R, G, B
        # and reverses them.
        png.write_png(encoded / f"{stems[k]}.png",
                      np.ascontiguousarray(cyclomedia_depth(mm)[..., ::-1]),
                      level=1)

    list(pool.map(write_encoded, range(len(stems))))
    cam_dirs = sorted({(encoded / s).parent for s in stems})
    with step("depth_decode"):            # one camera folder a worker
        n_decoded = sum(len(params) for params in pool.map(
            lambda d: depth_decode.convert_depth_dir(d, depths / d.name),
            cam_dirs))
    with step("depth_scale"):
        fits = depth_scale.make_depth_scale(sparse, depths)
    if n_decoded != PRE_DEPTH_MAPS or len(fits) != PRE_DEPTH_MAPS or \
            not all(np.isfinite(v["scale"]) for v in fits.values()):
        raise AssertionError(f"preprocess: {n_decoded} decoded, "
                             f"{len(fits)} fitted")
    out["depth"] = {"maps": PRE_DEPTH_MAPS, "size": PRE_FACE,
                    "camera_folders": len(cam_dirs), "workers": PRE_WORKERS,
                    "fitted": sum(v["scale"] != 0.0 for v in fits.values())}

    # 8. mono depth: Depth-Anything vitl on the card from a checkpoint
    # file in the original repo's naming (random weights from the seed).
    with step("mono_weights"):
        cfg = depth_anything.VITL
        state = depth_anything.random_state(cfg, 37, seed=0)
        ckpt = root / "depth_anything_vitl.pth"
        torch.save(depth_anything.to_original_naming(state, cfg), ckpt)
        del state
    mono_in = root / "mono_images"
    for name in names[:PRE_MONO_IMAGES]:
        (mono_in / name).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(faces_dir / name, mono_in / name)
    torch.cuda.reset_peak_memory_stats()
    os.environ["DEPTH_ANYTHING_CKPT"] = str(ckpt)
    os.environ["DEPTH_ANYTHING_TARGET"] = str(PRE_MONO_TARGET)
    try:
        with step("mono_depth"), StageClock() as clock:
            clock.wrap(depth_anything, "infer_inverse_depth", "infer_ms",
                       device=True)
            clock.wrap(depth_anything, "load_checkpoint", "load_ms")
            n_mono = mono_depth.generate_depth(mono_in, root / "mono_depths",
                                               device=dev)
    finally:
        del os.environ["DEPTH_ANYTHING_CKPT"]
        del os.environ["DEPTH_ANYTHING_TARGET"]
    maps = sorted((root / "mono_depths").rglob("*.png"))
    first = png.read_image(maps[0])
    if n_mono != PRE_MONO_IMAGES or len(maps) != n_mono or \
            first.dtype != np.uint16 or first.shape != (PRE_FACE, PRE_FACE) \
            or int(first.max()) != 65535:
        raise AssertionError("preprocess: mono depth PNG contract")
    out["mono_depth"] = {
        "model": "vitl (hidden 1024, 24 layers, 16 heads, taps "
                 f"{cfg.out_indices}, neck {cfg.neck_sizes}, fusion "
                 f"{cfg.fusion}), random weights",
        "images": n_mono, "target": PRE_MONO_TARGET,
        "load_checkpoint_ms": clock.ms["load_ms"],
        "ms_per_image_wall": clock.ms["infer_ms"] / n_mono,
        "ms_per_image_device": clock.ms["infer_ms_device"] / n_mono,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    # The card against the CPU on a 4-layer model at vitl width.
    with step("mono_check"):
        small = dataclasses.replace(cfg, layers=PRE_MONO_CHECK_LAYERS,
                                    out_indices=(0, 1, 2, 3))
        state = depth_anything.random_state(small, 37, seed=1)
        x, _ = depth_anything.preprocess_image(street_face(base, 0),
                                               PRE_MONO_TARGET, "cpu")
        with torch.no_grad():
            cpu = depth_anything.build_model(state, small, "cpu")(x)
            card_out = depth_anything.build_model(state, small, dev)(
                x.to(dev)).cpu()
    err = float((card_out - cpu).abs().max())
    scale = float(cpu.abs().max())
    if not math.isfinite(err) or scale <= 0 or err > PRE_MONO_RTOL * scale:
        raise AssertionError(f"preprocess: mono depth card vs CPU {err} "
                             f"(max|depth| {scale})")
    out["mono_check"] = {"layers": PRE_MONO_CHECK_LAYERS,
                         "input": list(x.shape), "max_abs_err": err,
                         "max_abs_depth": scale,
                         "tolerance": f"{PRE_MONO_RTOL} x max|depth|, TF32 "
                                      "off"}

    # 9. masks: process_images, batch confirm-all, precomputed detections.
    det_dir = root / "detections"
    hw = (PRE_FACE, PRE_FACE)
    person = np.zeros(hw, bool)
    person[900:1500, 400:600] = True
    car = np.zeros(hw, bool)
    car[1200:1600, 1000:1800] = True
    for name in names[:PRE_MASK_FACES]:
        (det_dir / name).parent.mkdir(parents=True, exist_ok=True)
        np.savez(det_dir / f"{name}.npz", labels=np.array([1, 3]),
                 scores=np.array([0.9, 0.8]), masks=np.stack([person, car]))
    with step("masks"):
        n_masks = mask_images.process_images(
            root, mask_images.precomputed_detector(det_dir),
            decide=lambda *_: True)
    keep = png.read_image((root / "inputs" / "masks" / names[0])
                          .with_suffix(".png"))
    want = np.where(person | car, 0, 255).astype(np.uint8)
    if n_masks != PRE_MASK_FACES or not np.array_equal(keep, want):
        raise AssertionError("preprocess: masks")
    out["masks"] = {"faces": n_masks}

    # 10. the CTM export of a street mesh, native against plain.
    side = int(math.sqrt(PRE_MESH_TRIS / 2)) + 1
    gx, gy = np.meshgrid(np.linspace(x_lo, x_hi, side),
                         np.linspace(-14, 14, side), indexing="ij")
    verts = np.stack([gx, gy, 0.1 * np.sin(gx / 7.0)], -1).reshape(-1, 3)
    q = (np.arange(side - 1)[:, None] * side
         + np.arange(side - 1)[None, :]).reshape(-1)
    tris = np.concatenate([np.stack([q, q + side, q + 1], 1),
                           np.stack([q + 1, q + side, q + side + 1], 1)]
                          ).astype(np.int32)
    with step("ctm_export"):
        written = depth_pipeline.mesh_to_ctm_tiles(verts, tris,
                                                   root / "ctm", 100.0)
    v0, t0 = ctm.load_ctm(written[0])
    ctm.save_ctm_plain(root / "plain.ctm", v0,
                       t0, json.loads(written[0].with_suffix(
                           ".offset.json").read_text()))
    ctm.save_ctm(root / "native.ctm", v0, t0,
                 json.loads(written[0].with_suffix(".offset.json")
                            .read_text()))
    if (root / "plain.ctm").read_bytes() != (root / "native.ctm") \
            .read_bytes():
        raise AssertionError("preprocess: CTM native and plain differ")
    out["ctm"] = {"triangles": int(tris.shape[0]), "tiles": len(written)}
    pool.shutdown()
    out.update(seconds=time.perf_counter() - t_all, step_seconds=steps)
    emit(out)
    return out


# ---- 18-24. the root drivers: tools/ on the card -----------------------------
# bench, bench_street, microbench and parity run at their full sizes;
# convergence, pipeline_quality and fork_features at a cut depth (their
# full-depth runs are the tools' own, PERF.md section 4): convergence
# CONV_ITERS of 1,500 iterations a method, the pipelines a TOOL_DEPTH_CUT-th
# of their 200 coarse, 800 chunk and 300 post steps.  Each tool's printed
# lines go to build/smoke/tools/<phase>.log.
CONV_ITERS = 200
TOOL_DEPTH_CUT = 8
STREET_EXACT_FLAGS = ["--two-level", "--max-dup", "2", "--tile-capacity",
                      "128", "--exact-extra", "9216", "--dup-overscan", "32",
                      "--grad-reduce", "counts", "--grad-sort", "bf16"]
TOOL_KERNELS = ("slab_gather", "blend_padded", "blend_padded_bwd",
                "blend_exact", "blend_exact_bwd")
JAX_BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]
JAX_STREET_KEYS = ["metric", "value", "unit", "vs_baseline", "step_ms",
                   "config", "pairs", "visible"]


def tool_run(phase: str, fn, expect: tuple) -> tuple:
    """Drive ``fn()`` with the launch counts set to 0 just before and read
    just after, the first call of each kernel kept (``Recorder``,
    first_only) and the tool's stdout sent to its log.  Fails if a kernel
    of ``expect`` was never launched (with ``expect`` empty, if any kernel
    was; ``None`` checks nothing).  Returns (result, launches, {kernel: (args, out)}, the
    tool's printed text)."""
    import io
    from street_sparse_3dgs_tpu_torch import native
    from street_sparse_3dgs_tpu_torch.ops import binning
    from street_sparse_3dgs_tpu_torch.ops import cuda_blend as cb

    logs = ROOT / "build" / "smoke" / "tools"
    logs.mkdir(parents=True, exist_ok=True)
    buf = io.StringIO()
    with contextlib.ExitStack() as stack:
        recs = {key: stack.enter_context(Recorder(
            binning if key == "slab_gather" else cb, key, first_only=True))
            for key in TOOL_KERNELS}
        stack.enter_context(contextlib.redirect_stdout(buf))
        native.reset_launches()
        try:
            result = fn()
        finally:
            launches = dict(native.LAUNCHES)
            (logs / f"{phase}.log").write_text(buf.getvalue())
    for key in expect or ():
        if launches[key] == 0:
            raise AssertionError(f"{phase} never launched {key}")
    if expect == () and any(launches.values()):
        raise AssertionError(f"{phase} launched a kernel: {launches}")
    calls = {key: r.calls[0] for key, r in recs.items() if r.calls}
    return result, launches, calls, buf.getvalue()


def tool_held(key: str, args, out, sfu_rate: float, phase: str) -> dict:
    """A tool phase's recorded blend call held against the plain version
    (the forward bar with the flip share, the grad bar), timed (device and
    wall ms, the plain version's) and bounded."""
    from street_sparse_3dgs_tpu_torch.ops import cuda_blend as cb
    from street_sparse_3dgs_tpu_torch.profiling import device_ms, event_ms

    kern, plain = getattr(cb, key), getattr(cb, key + "_plain")
    exact = key.startswith("blend_exact")
    want = plain(*args)
    if key.endswith("_bwd"):
        cmp = compare_grads(f"{key} at {phase}", out, want, 2 if exact else 1)
        b_ms, b_by, live, walk = bwd_bound(args, exact, sfu_rate)
    else:
        cmp = compare_blend(out, want)
        check_blend(f"{key} at {phase}", cmp, strict=False)
        b_ms, b_by, live, walk = fwd_bound(args, out, exact, sfu_rate)
    return {"ms": device_ms(lambda: kern(*args), 20),
            "wall_ms": event_ms(lambda: kern(*args), 20),
            "plain_ms": event_ms(lambda: plain(*args), 2),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "max_abs_err": cmp["max_abs_err"],
            **({"max_scaled_err": cmp["max_scaled_err"]} if "max_scaled_err"
               in cmp else {"flips": cmp["flips"]}),
            "tiles": (args[3] if exact else args[0]).shape[0],
            "live_slots": live, **walk}


def finite(*xs) -> bool:
    return all(isinstance(x, (int, float)) and math.isfinite(x) for x in xs)


def tool_phases(dev, scene) -> dict:
    """Phases 18-24: each tool's ``main`` in this process (``--device``
    DEVICE), its record checked and emitted.  Returns {phase: {launches,
    calls}} for the kernels line."""
    from street_sparse_3dgs_tpu_torch.pipeline import full_train as ft
    from street_sparse_3dgs_tpu_torch.tools import (bench, bench_street,
                                                    convergence,
                                                    fork_features,
                                                    microbench, parity,
                                                    pipeline_quality)
    out = {}

    def done(phase: str, rec: dict, launches: dict, calls: dict, t0):
        torch.cuda.synchronize()
        rec = {"phase": phase, "seconds": time.perf_counter() - t0, **rec,
               "launches": launches}
        emit(rec)
        out[phase] = {"launches": launches, "calls": calls}

    # 18. bench: bench.py's config, K5, K1, K2.
    t0 = time.perf_counter()
    res, launches, calls, _ = tool_run(
        "bench", lambda: bench.main(["--device", DEVICE]),
        ("slab_gather", "blend_padded", "blend_padded_bwd"))
    line = {k: v for k, v in res.items() if k != "grads"}
    timed = [line["value"], line["step_ms"]] + (
        [line["device_ms"], line["device_busy_ms"]] if dev.type == "cuda"
        else [])
    if list(line)[:4] != JAX_BENCH_KEYS or not line["grads_finite"] or \
            not finite(*timed):
        raise AssertionError(f"bench: bad record {line}")
    if line["tile_overflow"] <= 0:
        raise AssertionError("bench: the bench config's overflow was not "
                             f"counted: {line}")
    done("bench", {"line": line}, launches, calls, t0)
    del res

    # 19. bench_street on phase render's scene at 1920x1088, 4 cameras: the
    # tool's padded default and the production exact config (profiled).
    t0 = time.perf_counter()
    runs, all_launches, all_calls = {}, {}, {}
    base = ["--n", str(N_ROWS), "--width", str(WIDTH), "--height",
            str(HEIGHT), "--cameras", str(N_VIEWS), "--device", DEVICE]
    for name, flags, expect in (
            ("padded", [], ("slab_gather", "blend_padded",
                            "blend_padded_bwd")),
            ("exact", STREET_EXACT_FLAGS + ["--profile"],
             ("slab_gather", "blend_exact", "blend_exact_bwd"))):
        res, launches, calls, _ = tool_run(
            f"bench_street_{name}",
            lambda: bench_street.main(base + flags, scene=scene), expect)
        line = {k: v for k, v in res.items() if k not in ("grads", "stats",
                                                          "profile")}
        if list(line)[:len(JAX_STREET_KEYS)] != JAX_STREET_KEYS or \
                not line["grads_finite"] or \
                not finite(line["value"], line["step_ms"]):
            raise AssertionError(f"bench_street {name}: bad record {line}")
        if name == "exact" and line["step_tile_overflow_max"]:
            raise AssertionError("bench_street exact: tile_overflow in a "
                                 f"counts step: {line}")
        runs[name] = {"line": line, "stats": res["stats"]}
        if name == "exact":
            prof = res["profile"]
            runs[name]["profile"] = {"top": prof["top"][:12]}
            if "device_busy_ms" in prof:
                runs[name]["profile"].update(
                    device_busy_ms_per_step=prof["device_busy_ms"]
                    / bench_street.parser().get_default("iters"),
                    device_idle_share=prof["device_idle_share"])
        for k, v in launches.items():
            all_launches[k] = all_launches.get(k, 0) + v
        all_calls.update({f"{k}@{name}": c for k, c in calls.items()})
        del res
    done("bench_street", {"runs": runs}, all_launches, all_calls, t0)

    # 20. microbench: every candidate held against its reference first.
    t0 = time.perf_counter()
    res, launches, calls, _ = tool_run("microbench",
                                       lambda: microbench.main(["--device", DEVICE]), ())
    done("microbench", {"candidates": len(res["ms"]), "ms": res["ms"],
                        "max_check_err": max(res["checks"].values())},
         launches, calls, t0)

    # 21. parity: oracle, tiled, kernels padded and exact at 128x96.
    t0 = time.perf_counter()
    res, launches, calls, _ = tool_run(
        "parity", lambda: parity.main(["--device", DEVICE]), TOOL_KERNELS)
    if not res["passed"]:
        raise AssertionError(f"parity: {res['failures']}")
    done("parity", {"diffs": res["diffs"],
                    "bar": f"image < {parity.IMAGE_BAR}, grads within "
                           f"{parity.GRAD_FACTOR}x tiled-oracle"},
         launches, calls, t0)
    del res

    # 22. convergence: the three methods side by side on identical inputs.
    t0 = time.perf_counter()
    recs, launches, calls, _ = tool_run(
        "convergence", lambda: convergence.main(
            ["--methods", ",".join(convergence.METHODS), str(CONV_ITERS),
             "--device", DEVICE]), TOOL_KERNELS)
    by = {r["method"]: r for r in recs}
    if not all(finite(r["psnr"], *r["per_view"]) for r in recs):
        raise AssertionError(f"convergence: PSNR not finite {by}")
    done("convergence", {
        "iters": CONV_ITERS, "cut_from": 1500,
        "methods": {m: {k: r[k] for k in ("psnr", "per_view", "n_active",
                                          "wall_s", "skipped_updates",
                                          "tile_overflow", "dup_overflow")}
                    for m, r in by.items()},
        "gap_db_vs_tiled": {m: by[m]["psnr"] - by["tiled"]["psnr"]
                            for m in ("pallas", "pallas-exact")}},
        launches, calls, t0)

    # 23-24. the pipelines at a cut depth, each run twice (the rerun skips).
    cut = {k: v // TOOL_DEPTH_CUT for k, v in pipeline_quality.DEPTHS.items()}

    def pipeline_phase(phase, mod, argv_of, expect, check):
        """Run the tool over ``argv_of`` at the cut depth, then again: the
        rerun must skip every stage of every run and keep each merged
        tree."""
        t0 = time.perf_counter()
        real = mod.DEPTHS
        mod.DEPTHS = cut
        try:
            res, launches, calls, _ = tool_run(phase, lambda: [
                mod.main(argv) for argv in argv_of], expect)
            stamps = merged_stamps()
            again, _, _, text = tool_run(f"{phase}_rerun", lambda: [
                mod.main(argv) for argv in argv_of], None)
        finally:
            mod.DEPTHS = real
        runs = sum("--report" not in argv for argv in argv_of)
        if not (text.count("Skipping coarse") == runs
                and text.count("Skipping chunk 0_0") == runs
                and text.count("Skipping chunk 1_0") == runs
                and "== Stage 2" not in text
                and merged_stamps() == stamps):
            raise AssertionError(f"{phase}: the rerun did not skip: "
                                 f"{text[-2000:]!r}")
        rec = check(res, again)
        rec.update(depths=cut, cut_from=dict(real), rerun_skipped=True)
        done(phase, rec, launches, calls, t0)

    pq_dir = ROOT / "build" / "smoke" / "pipe_quality"
    ff_dir = ROOT / "build" / "smoke" / "fork_features"
    shutil.rmtree(pq_dir, ignore_errors=True)
    shutil.rmtree(ff_dir, ignore_errors=True)

    def merged_stamps():
        return sorted((str(p), p.stat().st_mtime_ns) for d in (pq_dir, ff_dir)
                      if d.exists() for p in d.rglob("merged.hier.npz"))

    def check_pq(res, again):
        (r,), (r2,) = res, again
        paths = ft.ProjectPaths(pq_dir)
        need = [paths.output_dir / "merged.hier.npz",
                paths.output_dir / "training_pipeline_timing.txt"] + [
            paths.trained_chunks_dir / c / f"hierarchy.{h}.npz"
            for c in ("0_0", "1_0") for h in ("hier", "hier_opt")]
        missing = [str(p) for p in need if not p.exists()]
        sweep = {f"{t:g}": {k: v for k, v in r["merged_test"][t].items()
                            if isinstance(v, float)} for t in TAUS}
        vals = [v for d in sweep.values() for v in d.values()] + [
            r["merged_train"]["psnr"]] + [
            row[s]["psnr"] for row in r["per_chunk"].values()
            for s in ("test", "train")]
        if missing or not finite(*vals) or len(r["per_chunk"]) != 4 or \
                sweep["15"]["psnr"] > sweep["0"]["psnr"] + 0.1 or \
                r2["merged_test"][0.0]["psnr"] != r["merged_test"][0.0]["psnr"]:
            raise AssertionError(f"pipeline_quality: missing {missing} or "
                                 f"bad metrics {sweep} {r['per_chunk']}")
        pipe = pipeline_quality.pipe_config("pallas", False, False, "f32")
        return {"config": {k: getattr(pipe, k) for k in (
                    "raster_method", "tile_capacity", "max_dup",
                    "exact_extra")}, "train_s": r["train_s"],
                "per_chunk": {k: {s: v[s]["psnr"] for s in ("test", "train")}
                              for k, v in r["per_chunk"].items()},
                "merged_test": sweep,
                "merged_train_psnr": r["merged_train"]["psnr"],
                "n_nodes": r["n_nodes"]}

    pipeline_phase("pipeline_quality", pipeline_quality,
                   [["--dir", str(pq_dir), "--device", DEVICE]],
                   ("slab_gather", "blend_padded", "blend_padded_bwd"),
                   check_pq)

    def check_ff(res, again):
        arms = {}
        for arm, r in zip(("on", "off"), res):
            saved = json.loads((ff_dir / arm / "results.json").read_text())
            if saved != json.loads(json.dumps(r)) or sorted(saved) != [
                    "n_nodes", "test", "train"] or not finite(
                    *saved["test"].values(), *saved["train"].values()):
                raise AssertionError(f"fork_features {arm}: {saved}")
            arms[arm] = saved
        if [json.loads(json.dumps(r)) for r in again[:2]] != [
                arms["on"], arms["off"]]:
            raise AssertionError("fork_features: the rerun's results differ")
        pipe = fork_features.pipe_config(dev)
        return {"config": {k: getattr(pipe, k) for k in (
                    "raster_method", "tile_capacity", "max_dup",
                    "exact_extra", "grad_sort")}, "arms": arms,
                "on_minus_off": {k: arms["on"]["test"][k]
                                 - arms["off"]["test"][k]
                                 for k in arms["on"]["test"]}}

    pipeline_phase("fork_features", fork_features,
                   [["--dir", str(ff_dir), "--arm", arm, "--device", DEVICE]
                    for arm in ("on", "off")]
                   + [["--dir", str(ff_dir), "--report"]],
                   # (the tiled plain path on the CPU, as the JAX tool's)
                   ("slab_gather", "blend_exact", "blend_exact_bwd")
                   if fork_features.pipe_config(dev).raster_method
                   == "pallas" else None, check_ff)
    return out


# ---- the projection pair at the street shape ------------------------------

def project_kernels(rows, cam, launches_of) -> list:
    """``project_fwd`` and ``project_bwd`` (``csrc/project.cu``) on the
    street scene's rows at SH degree 3: held against the plain path as
    ``tests/test_torch_project_card.py`` holds them (the forward's outputs
    against ``project_gaussians_plain``; the backward against
    ``project_backward_plain`` on well-conditioned rows, per leaf norm),
    then timed: ``ms`` a bare launch's device time, ``wall_ms`` the wrapper
    (the forward; the forward and its backward under autograd), beside the
    bound by bytes (each input and output once) and the plain versions'
    times.  Returns the two kernel entries."""
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_project_card as card
    from street_sparse_3dgs_tpu_torch import native
    from street_sparse_3dgs_tpu_torch.ops import preprocess as pp
    from street_sparse_3dgs_tpu_torch.profiling import (PEAK_BYTES_S,
                                                        device_ms, event_ms)

    names = card.COTANGENTS
    means, scales, quats, opac, sh = rows
    n, k = means.shape[0], sh.shape[1]
    got = pp.project_gaussians(*rows, cam, 3)
    want = pp.project_gaussians_plain(*rows, cam, 3)
    worst = card.compare_forward(got, want, rows, cam, 3, 1.0, None,
                                 "street")
    leaves = [x.detach().clone().requires_grad_(True) for x in rows]
    out = pp.project_gaussians(*leaves, cam, 3)
    cots = card.random_cotangents(out, 7)
    cots["depth"] = torch.where(out.valid, cots["depth"], 0.0)
    grads = torch.autograd.grad([getattr(out, c) for c in names],
                                leaves, [cots[c] for c in names])
    plain = pp.project_backward_plain(
        means, scales, quats, sh, cam, 3,
        **{f"g_{c}": cots[c] for c in names})
    ok = card.well_conditioned(rows, cam, 3, None)
    grad_err = {name: float((x[ok] - y[ok]).norm() / y[ok].norm())
                for name, x, y in zip(card.LEAVES, grads, plain)}
    if max(grad_err.values()) > card.GRAD_NORM_RTOL:
        raise AssertionError(f"project_bwd: off the plain version {grad_err}")

    cam_t = pp._camera_tensors(cam, means.device)
    ptrs = [t.data_ptr() for t in cam_t]
    outs = [torch.empty_like(x) for x in got]
    d = [torch.empty_like(x) for x in rows]
    g = [cots[c] for c in names]

    def fwd():
        native.launch("project_fwd", means.data_ptr(), scales.data_ptr(),
                      quats.data_ptr(), opac.data_ptr(), sh.data_ptr(), None,
                      *ptrs, n, k, 3, cam.width, cam.height, 1.0,
                      *(o.data_ptr() for o in outs))

    def bwd():
        native.launch("project_bwd", means.data_ptr(), scales.data_ptr(),
                      quats.data_ptr(), sh.data_ptr(), None, *ptrs, n, k, 3,
                      cam.width, cam.height, 1.0, *(x.data_ptr() for x in g),
                      *(x.data_ptr() for x in d))

    def kernel_pair():
        o = pp.project_gaussians(*leaves, cam, 3)
        torch.autograd.grad([getattr(o, c) for c in names],
                            leaves, g)

    def plain_pair():
        o = pp.project_gaussians_plain(*leaves, cam, 3)
        torch.autograd.grad([torch.where(torch.isfinite(getattr(o, c)),
                                         getattr(o, c), 0.0)
                             for c in names], leaves, g)

    fwd_ms, bwd_ms = device_ms(fwd, 50), device_ms(bwd, 50)
    fwd()
    bwd()
    if not all(torch.equal(a, b) for a, b in zip(outs, got)) or not all(
            torch.equal(a.view(torch.int32), b.view(torch.int32))
            for a, b in zip(d, grads)):
        raise AssertionError("project: a bare launch differs from the "
                             "wrapper's")
    # Bytes a row: forward means, scales, quats, opacity and K SH
    # coefficients in, the eight outputs (49 B) out; backward the same
    # inputs but opacity, six cotangents (44 B) in, five gradients out.
    fwd_bytes = n * (12 + 12 + 16 + 4 + 12 * k + 49)
    bwd_bytes = n * (12 + 12 + 16 + 12 * k + 44 + 12 + 12 + 16 + 4 + 12 * k)
    common = {"route": "cuda",
              "source": "street_sparse_3dgs_tpu_torch/csrc/project.cu",
              "replaces": "none (XLA's fusion of street_sparse_3dgs_tpu/ops/"
                          "preprocess.project_gaussians and its VJP; the "
                          "port's plain chain in PyTorch)",
              "bound_by": "bytes", "library_ms": None,
              "shapes": f"street view 0, {n} rows, K {k}, degree 3"}
    return [
        {"name": "project_fwd", **common, **launches_of("project_fwd"),
         "tolerance": f"rtol {card.RTOL} on rows valid on both, beyond "
                      f"{card.FP32_SLACK}x the plain path's own float32 "
                      "error against float64",
         "max_rel_err": worst, "ms": fwd_ms,
         "wall_ms": event_ms(lambda: pp.project_gaussians(*rows, cam, 3), 50),
         "plain_ms": event_ms(
             lambda: pp.project_gaussians_plain(*rows, cam, 3), 5),
         "bound_ms": fwd_bytes / PEAK_BYTES_S * 1e3},
        {"name": "project_bwd", **common, **launches_of("project_bwd"),
         "tolerance": "1e-4 per leaf norm on well-conditioned rows",
         "grad_rel_err": grad_err, "ms": bwd_ms,
         "wall_ms_with_fwd": event_ms(kernel_pair, 20),
         "plain_ms": event_ms(lambda: pp.project_backward_plain(
             means, scales, quats, sh, cam, 3,
             **{f"g_{c}": cots[c] for c in names}), 3),
         "plain_autograd_ms_with_fwd": event_ms(plain_pair, 3),
         "bound_ms": bwd_bytes / PEAK_BYTES_S * 1e3}]


def _meta(n: int):
    from street_sparse_3dgs_tpu_torch.models.gaussians import GaussianMeta
    return GaussianMeta(sh_degree=3, capacity=n)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from street_sparse_3dgs_tpu_torch import native
    from street_sparse_3dgs_tpu_torch.config import PipelineConfig
    from street_sparse_3dgs_tpu_torch.data.toy import (make_street_scene,
                                                       make_toy_scene)
    from street_sparse_3dgs_tpu_torch.hierarchy.build import build_hierarchy
    from street_sparse_3dgs_tpu_torch.hierarchy.io import (load_hierarchy,
                                                           save_hierarchy)
    from street_sparse_3dgs_tpu_torch.hierarchy.render import (
        render_cut_compact)
    from street_sparse_3dgs_tpu_torch.hierarchy.structure import (pixel_limit,
                                                                  select_cut)
    from street_sparse_3dgs_tpu_torch.models.gaussians import GaussianParams
    from street_sparse_3dgs_tpu_torch.ops import binning
    from street_sparse_3dgs_tpu_torch.ops import cuda_blend as cb
    from street_sparse_3dgs_tpu_torch.ops.preprocess import project_gaussians
    from street_sparse_3dgs_tpu_torch.ops.rasterize import (RasterConfig,
                                                            rasterize)
    from street_sparse_3dgs_tpu_torch.profiling import (PEAK_BYTES_S,
                                                        device_ms, event_ms,
                                                        smi)
    from street_sparse_3dgs_tpu_torch.tools import kernel_floor as kf

    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("float32 matmuls must run in full precision")
    dev = torch.device(DEVICE)
    t_all = time.perf_counter()

    # ---- 1. build -------------------------------------------------------
    info = native.build()
    card = smi("name,power.limit")
    print(card, flush=True)
    # The special-function rate of the bounds (the memory and f32 peaks
    # are profiling.PEAK_BYTES_S / PEAK_FLOP_S).
    sfu_rate = kf.sfu_rate_of_card()
    emit({"phase": "build", "seconds": info["seconds"],
          "built": info["built"], "ptxas": info["ptxas"], "card": card,
          "sms": torch.cuda.get_device_properties(0).multi_processor_count,
          "max_sm_mhz": float(smi("clocks.max.sm").split()[0]),
          "sfu_rate": sfu_rate})

    # ---- 2. kernels at small shapes ----------------------------------------
    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(0)
    t_small, k_small, tiles_x = 12, 256, 4
    attrs = torch.zeros(t_small, 10, k_small)
    attrs[:, 0] = torch.rand(t_small, k_small, generator=g) * 64
    attrs[:, 1] = torch.rand(t_small, k_small, generator=g) * 48
    attrs[:, 2] = 0.02 + 0.1 * torch.rand(t_small, k_small, generator=g)
    attrs[:, 3] = 0.01 * torch.randn(t_small, k_small, generator=g)
    attrs[:, 4] = 0.02 + 0.1 * torch.rand(t_small, k_small, generator=g)
    attrs[:, 5:8] = torch.rand(t_small, 3, k_small, generator=g)
    attrs[:, 8] = torch.rand(t_small, k_small, generator=g)
    attrs[:, 9] = torch.rand(t_small, k_small, generator=g)
    counts = torch.randint(0, 300, (t_small,), generator=g, dtype=torch.int32)
    bgs = (torch.tensor([[0.2, 0.1, 0.3]]), torch.rand(t_small, 3, generator=g))
    small = {}
    for bg in bgs:
        for tile0 in (0, 5):
            a = [x.to(dev) for x in (attrs, counts, bg)]
            k_out = cb.blend_padded(*a, tiles_x, tile0, t_small)
            p_out = cb.blend_padded_plain(*a, tiles_x, tile0, t_small)
            cmp = compare_blend(k_out, p_out)
            check_blend("K1 small", cmp, strict=True)
            small[f"K1 tile0={tile0} bg={tuple(bg.shape)}"] = cmp
    # K3: 5 real tiles over 12 used windows (+8 budget windows never read).
    pairs = attrs.permute(0, 2, 1).reshape(-1, 10)[:20 * 128]
    pairs = pairs.reshape(20, 128, 10).contiguous()
    vcounts = torch.tensor([128, 128, 40, 100, 128, 7, 0, 128, 128, 128, 128,
                            3] + [0] * 8, dtype=torch.int32)
    wt = torch.tensor([0, 1, 2, 0, 0, 1, 0, 0, 1, 2, 3, 4] + [0] * 8,
                      dtype=torch.int32)
    last_v = torch.tensor([2, 3, 5, 6, 11], dtype=torch.int32)
    a = [x.to(dev) for x in (pairs, vcounts, wt, last_v,
                             torch.tensor([[0.2, 0.1, 0.3]]))]
    cmp = compare_blend(cb.blend_exact(*a, 3), cb.blend_exact_plain(*a, 3))
    check_blend("K3 small", cmp, strict=True)
    small["K3"] = cmp
    vals = torch.sort(torch.randint(0, 1 << 40, (5000,), generator=g)).values
    starts = torch.sort(torch.randint(0, 5000, (13,), generator=g)).values
    cnts = torch.clamp(5000 - starts, max=300).to(torch.int32)
    a = [x.to(dev) for x in (vals, starts.to(torch.int32), cnts)]
    if not torch.equal(binning.slab_gather(*a, 256, 12, 5000),
                       binning.slab_gather_plain(*a, 256, 12, 5000)):
        raise AssertionError("K5 small: kernel table differs from plain")
    # K5 edges: 21 rows (not a multiple of the kernel's 8 a block), empty
    # rows (budget windows no tile uses), rows over K, and the last two
    # segments flush with the end of vals (one of exactly K keys, one
    # ending inside a 4-slot group); K = 100 is not a multiple of 128.
    for k_cap in K5_EDGE_KS:
        m, t_rows = 9000, 21
        vals = torch.sort(torch.randint(0, 1 << 40, (m,), generator=g)).values
        starts = torch.randint(0, m - 2 * k_cap, (t_rows,), generator=g)
        cnts = torch.randint(0, 2 * k_cap, (t_rows,), generator=g)
        cnts[::5] = 0
        cnts[1::5] = 2 * k_cap
        starts[-2:] = torch.tensor([m - k_cap, m - k_cap // 2 - 3])
        cnts[-2:] = torch.tensor([k_cap, k_cap // 2 + 3])
        a = [x.to(dev) for x in (vals, starts.to(torch.int32),
                                 cnts.to(torch.int32))]
        if not torch.equal(binning.slab_gather(*a, k_cap, 12, m),
                           binning.slab_gather_plain(*a, k_cap, 12, m)):
            raise AssertionError(f"K5 edges at K = {k_cap}: kernel table "
                                 "differs from plain")
    small["K5"] = f"equal (K = 256; edges at K = {list(K5_EDGE_KS)})"
    # K2 / K4: each kernel's backward on the saved rows of its forward and a
    # random cotangent, against the plain backward on the same saved rows,
    # launched twice (bit-identical).  Terminate bait in tiles 0-5: forty
    # wide, 0.6-opaque slots over the whole image in slots 20-59, so walks
    # stop inside the slot list, across a 32-slot chunk boundary.
    bait = attrs.clone()
    bait[:6, 0, 20:60], bait[:6, 1, 20:60] = 32.0, 24.0
    bait[:6, 2, 20:60], bait[:6, 3, 20:60], bait[:6, 4, 20:60] = 5e-4, 0, 5e-4
    bait[:6, 8, 20:60] = 0.6
    counts_b = counts.clone()
    counts_b[:6] = torch.clamp(counts_b[:6], min=100)
    g_small = torch.randn(t_small, 8, 256, generator=g)
    for bg in bgs:
        for tile0 in (0, 5):
            a = [x.to(dev) for x in (bait, counts_b, bg)]
            grid = (tiles_x, tile0, t_small)
            saved = cb.blend_padded(*a, *grid)
            go = g_small.to(dev)
            d1 = cb.blend_padded_bwd(*a, saved, go, *grid)
            d2 = cb.blend_padded_bwd(*a, saved, go, *grid)
            cmp = compare_grads("K2 small", d1,
                                cb.blend_padded_bwd_plain(*a, saved, go,
                                                          *grid), 1)
            if not torch.equal(d1, d2):
                raise AssertionError("K2 small: two launches differ")
            live = torch.clamp(a[1].to(torch.int64), max=k_small)[:, None]
            cmp["terminated_pixels"] = int((saved[:, 6] < live).sum())
            small[f"K2 tile0={tile0} bg={tuple(bg.shape)}"] = cmp
    # K2 with faint slots: a fifth of the slots at opacity 1/255 +- 1e-6
    # and wide, their alphas on both sides of the 1/255 test over the
    # frame; and at K = 100 (not a multiple of the 64-slot chunk), counts
    # over K.
    faint = attrs.clone()
    pick = torch.rand(t_small, k_small, generator=g) < 0.2
    faint[:, 8] = torch.where(pick, 1 / 255 + 2e-6 * (torch.rand(
        t_small, k_small, generator=g) - 0.5), faint[:, 8])
    wide = 10 ** (-7 + 2.5 * torch.rand(t_small, k_small, generator=g))
    for ch in (2, 4):
        faint[:, ch] = torch.where(pick, wide, faint[:, ch])
    faint[:, 3] = torch.where(pick, torch.zeros_like(wide), faint[:, 3])
    for name, (a_k, c_k) in {
            "faint slots": (faint, counts),
            "K=100": (attrs[:, :, :100].contiguous(), torch.randint(
                0, 130, (t_small,), generator=g, dtype=torch.int32))}.items():
        a = [x.to(dev) for x in (a_k, c_k, bgs[1])]
        grid = (tiles_x, 0, 0)
        saved = cb.blend_padded(*a, *grid)
        go = g_small.to(dev)
        d1 = cb.blend_padded_bwd(*a, saved, go, *grid)
        want = cb.blend_padded_bwd_plain(*a, saved, go, *grid)
        cmp = compare_grads(f"K2 small {name}", d1, want, 1)
        if not torch.equal(d1, cb.blend_padded_bwd(*a, saved, go, *grid)):
            raise AssertionError(f"K2 small {name}: two launches differ")
        small[f"K2 {name}"] = cmp
    pairs_b = bait.permute(0, 2, 1).reshape(-1, 10)[:20 * 128]
    a = [x.to(dev) for x in (pairs_b.reshape(20, 128, 10).contiguous(),
                             vcounts, wt, last_v,
                             torch.tensor([[0.2, 0.1, 0.3]]))]
    saved = cb.blend_exact(*a, 3)
    # K3's window split on this layout with its termination bait: groups of
    # 1, 2 and 3 windows (tile 4 has 5 windows, tile 0 has 3) and no split,
    # against the split's plain twin and the plain version, every pixel.
    for group in (0, 1, 2, 3):
        k_out = cb.blend_exact_launch(*a, 3, 0, None, group)
        checks = {"vs_plain": compare_blend(k_out,
                                            cb.blend_exact_plain(*a, 3))}
        if group:
            checks["vs_split_plain"] = compare_blend(
                k_out, cb.blend_exact_split_plain(*a, 3, group=group))
        for what, cmp in checks.items():
            check_blend(f"K3 small group={group} {what}", cmp, strict=True)
        small[f"K3 bait group={group}"] = checks
    go = g_small[:5].contiguous().to(dev)
    d1 = cb.blend_exact_bwd(*a, saved, go, 3)
    d2 = cb.blend_exact_bwd(*a, saved, go, 3)
    cmp = compare_grads("K4 small", d1,
                        cb.blend_exact_bwd_plain(*a, saved, go, 3), 2)
    if not torch.equal(d1, d2):
        raise AssertionError("K4 small: two launches differ")
    if d1[12:].any():
        raise AssertionError("K4 small: a budget window got a grad")
    rev = torch.arange(4, -1, -1, dtype=torch.int32, device=dev)
    if not torch.equal(cb.blend_exact_bwd(*a, saved, go, 3, order=rev), d1):
        raise AssertionError("K4 small: the launch order moved a grad")
    cmp["terminated_pixels"] = int(
        (saved[:, 6] < tile_pairs(*a[1:4])[:, None]).sum())
    small["K4"] = cmp
    # D1-D3: the kernel-floor stubs on K3's layout above (multi-window
    # tiles, an empty window, partial windows, unused budget windows, random
    # values in the padding lanes) and on a K = 256 layout (two 128-slot
    # blocks a window), every level in both layouts, split at groups of 0
    # (none), 1, 2, 3 and 4 windows, at 1, 2, 4 and 8 table rows a block,
    # against the plain versions (levels 0, -1, -2 equal; 2 and 1 within
    # kf.SUM_RTOL of each pixel's sum of |terms|, 3 within kf.MATH_RTOL at
    # all but kf.MATH_FLIP_SHARE of the pixels).
    stub_layouts = {
        "K=128": (pairs, vcounts, wt, last_v),
        "K=256": (attrs.permute(0, 2, 1).reshape(-1, 10)[:10 * 256]
                  .reshape(10, 256, 10).contiguous(),
                  torch.tensor([256, 200, 0, 129, 5, 256, 256, 60, 0, 0],
                               dtype=torch.int32),
                  torch.tensor([0, 1, 0, 0, 0, 0, 1, 2, 0, 0],
                               dtype=torch.int32),
                  torch.tensor([1, 2, 3, 4, 7], dtype=torch.int32))}
    stubs_small = {}
    for lname, (pm_attrs, vc, w, lv) in stub_layouts.items():
        for level in kf.LEVELS_D1 + (kf.MATH_LEVEL,):
            for pm in (True, False):
                a = pm_attrs if pm else pm_attrs.transpose(1, 2).contiguous()
                args = [x.to(dev) for x in (a, vc, w, lv, bgs[0])]
                want, terms = kf.blend_exact_stub_plain(*args, 3, level, pm)
                stubs_small[f"{lname} L{level} "
                            f"{'pair' if pm else 'channel'}-major"] = max(
                    kf.stub_error(kf.blend_exact_stub(*args, 3, level, pm,
                                                      tpb, group), want,
                                  terms, level)
                    for tpb in kf.TILES_PER_BLOCK_D3
                    for group in (0, 1, 2, 3, cb.EXACT_GROUP))
    small["D1-D3"] = stubs_small
    torch.cuda.synchronize()
    emit({"phase": "kernels_small", "seconds": time.perf_counter() - t0,
          "atol": IMG_ATOL, "grad_bar": GRAD_BAR, "checks": small})

    # ---- 3. whole-rasterize grads, card against CPU ---------------------
    t0 = time.perf_counter()
    res = grads_small(dev)
    emit({"phase": "grads_small", "seconds": time.perf_counter() - t0,
          "n": SMALL_N, "width": SMALL_W, "height": SMALL_H,
          "bar": f"{GRAD_BAR} * max|g| + {GRAD_RTOL} * |g|", "configs": res})

    # ---- 4. street render (main path, counted) ---------------------------
    t0 = time.perf_counter()
    scene = make_street_scene(seed=0, n=N_ROWS, n_cameras=N_VIEWS,
                              width=WIDTH, height=HEIGHT, device=dev)
    torch.cuda.synchronize()
    scene_s = time.perf_counter() - t0
    configs = {"exact": RasterConfig(**STREET, exact_extra=9216),
               "padded": RasterConfig(**{**STREET, "tile_capacity": 1024})}
    bg = torch.zeros(3, device=dev)
    rows = (scene.means3d, scene.scales, scene.quats, scene.opacities,
            scene.sh_coeffs)

    native.reset_launches()
    renders = []
    for v, cam in enumerate(scene.cameras):
        for cname, cfg in configs.items():
            ms, out = timed_runs(lambda: rasterize(*rows, cam, 3, bg, cfg))
            renders.append((v, cname, ms, out))
    launches_render = dict(native.LAUNCHES)
    for name in ("blend_padded", "blend_exact", "slab_gather", "bin_scan",
                 "project_fwd"):
        if launches_render[name] == 0:
            raise AssertionError(f"render path never launched {name}")

    # Comparison harness (launches here are not counted): rerun each view
    # once with the wrappers recorded, hold every kernel against its plain
    # version on the recorded inputs, and the image against the plain path.
    street = {}
    per_view = []
    for (v, cname, ms, out), cam in zip(
            renders, [c for c in scene.cameras for _ in configs]):
        cfg = configs[cname]
        blend_name = "blend_exact" if cfg.exact_extra else "blend_padded"
        with Recorder(binning, "slab_gather") as k5, \
                Recorder(binning, "bin_scan") as bs, \
                Recorder(cb, blend_name) as kb:
            again = rasterize(*rows, cam, 3, bg, cfg)
        k5_args, k5_out = k5.calls[0]
        if not torch.equal(k5_out, binning.slab_gather_plain(*k5_args)):
            raise AssertionError(f"K5 view {v} {cname}: table differs")
        bs_args, bs_out = bs.calls[0]
        if not all(torch.equal(k, p) for k, p in zip(
                bs_out, binning.bin_scan_plain(*bs_args))):
            raise AssertionError(f"bin_scan view {v} {cname}: differs from "
                                 "plain")
        b_args, b_out = kb.calls[0]
        plain_fn = (cb.blend_exact_plain if cfg.exact_extra
                    else cb.blend_padded_plain)
        p_out = plain_fn(*b_args)
        cmp = compare_blend(b_out, p_out)
        check_blend(f"{blend_name} view {v}", cmp, strict=False)
        if cfg.exact_extra:
            cmp["vs_split_plain"] = compare_blend(
                b_out, cb.blend_exact_split_plain(*b_args))
            check_blend(f"K3 view {v} vs split plain",
                        cmp["vs_split_plain"], strict=False)
        tiles_x = b_args[-1]
        ty = -(-cam.height // 16)
        plain_img = cb._to_image(p_out[:, :5], tiles_x, ty, cam.height,
                                 cam.width)
        main_img = torch.cat([out["render"], out["depth"],
                              out["alpha"][None]])
        if not torch.equal(main_img, torch.cat(
                [again["render"], again["depth"], again["alpha"][None]])):
            raise AssertionError(f"view {v} {cname}: render not repeatable")
        over = int(((main_img - plain_img).abs().amax(dim=0)
                    > IMG_ATOL).sum())
        if over > FLIP_SHARE * cam.height * cam.width:
            raise AssertionError(f"view {v} {cname}: {over} pixels over "
                                 f"{IMG_ATOL} against the plain path")
        img = out["render"]
        if tuple(img.shape) != (3, cam.height, cam.width) or \
                not bool(torch.isfinite(main_img).all()):
            raise AssertionError(f"view {v} {cname}: bad image")
        if v == 0:
            street[cname] = dict(k5=k5_args, k5_out=k5_out, blend=b_args,
                                 blend_out=b_out, plain_out=p_out,
                                 scan=bs_args, scan_out=bs_out)
        per_view.append({
            "view": v, "config": cname, "ms": ms,
            # Binned pairs: window counts plus what the budget dropped, or
            # the pre-clip tile counts.
            "pairs": int(k5_args[2].sum()) + (
                int(out["tile_overflow"]) if cfg.exact_extra else 0),
            "visible": int(out["visibility"].sum()),
            "tile_overflow": int(out["tile_overflow"]),
            "dup_overflow": int(out["dup_overflow"]),
            "vis_overflow": int(out["vis_overflow"]),
            "image_std": float(img.std()),
            "pixels_over_atol": over, "blend_vs_plain": cmp})
    torch.cuda.synchronize()
    emit({"phase": "render", "seconds": time.perf_counter() - t0,
          "scene_seconds": scene_s, "n": N_ROWS, "width": WIDTH,
          "height": HEIGHT, "timed_runs": TIMED_RUNS, "launches":
          launches_render, "views": per_view})

    # ---- 5. hierarchy: build, save/load, tau sweep (main path, counted) ----
    t0 = time.perf_counter()
    params = GaussianParams(
        xyz=scene.means3d, features_dc=scene.sh_coeffs[:, :1],
        features_rest=scene.sh_coeffs[:, 1:],
        log_scales=torch.log(scene.scales), quats=scene.quats,
        opacity_raw=scene.opacities[:, None])
    h = build_hierarchy(params, opacity_activation="abs", device=dev)
    build_s = time.perf_counter() - t0
    hier_path = ROOT / "build" / "smoke" / "street.hier.npz"
    save_hierarchy(hier_path, h)
    h2 = load_hierarchy(hier_path, device=dev)
    for name in ("parent", "child_count", "size", "box_center"):
        if not torch.equal(getattr(h, name), getattr(h2, name)):
            raise AssertionError(f"hierarchy field {name} changed on reload")
    if not torch.equal(h.params.xyz, h2.params.xyz):
        raise AssertionError("hierarchy params changed on reload")
    h = h2
    io_s = time.perf_counter() - t0 - build_s
    cfg = configs["exact"]

    native.reset_launches()
    cuts = []
    for v, cam in enumerate(scene.cameras):
        for tau in TAUS:
            lim = pixel_limit(tau, float(cam.tan_fovx), cam.width)
            cut_ms, cut = timed_runs(lambda: select_cut(h, cam.campos, lim))
            ms, out = timed_runs(lambda: render_cut_compact(
                h.params, cut, h.n_nodes, h.skybox_count, cam, 3, bg, cfg))
            cuts.append((v, tau, cut, cut_ms, ms, out))
    launches_hier = dict(native.LAUNCHES)
    for name in ("blend_exact", "slab_gather"):
        if launches_hier[name] == 0:
            raise AssertionError(f"hierarchy path never launched {name}")

    sweep = []
    for v, tau, cut, cut_ms, ms, out in cuts:
        cam = scene.cameras[v]
        with Recorder(cb, "blend_exact") as kb:
            render_cut_compact(h.params, cut, h.n_nodes, h.skybox_count, cam,
                               3, bg, cfg)
        b_args, b_out = kb.calls[0]
        cmp = compare_blend(b_out, cb.blend_exact_plain(*b_args))
        check_blend(f"K3 hierarchy view {v} tau {tau}", cmp, strict=False)
        img = out["render"]
        if tuple(img.shape) != (3, cam.height, cam.width) or \
                not bool(torch.isfinite(img).all()):
            raise AssertionError(f"hierarchy view {v} tau {tau}: bad image")
        sweep.append({"view": v, "tau": tau,
                      "cut_size": int(cut.selected.sum()),
                      "select_ms": cut_ms, "ms": ms,
                      "tile_overflow": int(out["tile_overflow"]),
                      "dup_overflow": int(out["dup_overflow"]),
                      "image_std": float(img.std()),
                      "blend_vs_plain": cmp})
    torch.cuda.synchronize()
    emit({"phase": "hierarchy", "seconds": time.perf_counter() - t0,
          "build_seconds": build_s, "save_load_seconds": io_s,
          "nodes": h.n_nodes, "launches": launches_hier, "sweep": sweep})
    del h, cuts

    # ---- 6. where the time goes: one exact-config render of view 0 --------
    t0 = time.perf_counter()
    cam, cfg = scene.cameras[0], configs["exact"]
    stages = {}
    stages["project"], proj = timed_runs(
        lambda: project_gaussians(*rows, cam, 3))
    stages["bin"], bins = timed_runs(lambda: binning.bin_gaussians(
        proj, cam.height, cam.width, cfg.max_dup, cfg.tile_capacity,
        vis_capacity=cfg.vis_capacity, exact_extra=cfg.exact_extra,
        dup_overscan=cfg.dup_overscan, dup_tails=cfg.dup_tails))
    stages["pack"], attrs = timed_runs(lambda: cb.pack_gather_attrs(
        bins.gather, proj.mean2d, proj.conic, proj.color, proj.opacity,
        proj.inv_depth, order=bins.order, rank=bins.rank, pair_major=True))
    stages["blend K3"], flat = timed_runs(lambda: cb.blend_exact(
        attrs, bins.vcounts, bins.wt, bins.last_v, bg.reshape(1, 3),
        bins.tiles_x))
    stages["assemble"], _ = timed_runs(lambda: cb._to_image(
        flat[:, :5], bins.tiles_x, bins.tiles_y, cam.height,
        cam.width).contiguous())
    stages["end_to_end"], _ = timed_runs(
        lambda: rasterize(*rows, cam, 3, bg, cfg))
    prof = device_profile(lambda: rasterize(*rows, cam, 3, bg, cfg))
    del proj, bins, attrs, flat
    emit({"phase": "layers", "seconds": time.perf_counter() - t0,
          "view": 0, "config": "exact", "stage_ms": stages, **prof})

    # ---- 7. kernel floor: K3 against the stubs D1-D3 (main path, counted) -
    t0 = time.perf_counter()
    native.reset_launches()
    floor = kf.measure(street["exact"]["blend"])
    launches_floor = dict(native.LAUNCHES)
    if launches_floor["blend_exact_stub"] == 0:
        raise AssertionError("kernel_floor never launched blend_exact_stub")
    stub_tolerance = (f"levels 0, -1, -2 equal; levels 2, 1 within "
                      f"{kf.SUM_RTOL} x sum|terms| per pixel; level "
                      f"{kf.MATH_LEVEL} within {kf.MATH_RTOL} x sum|terms| "
                      f"at all but {kf.MATH_FLIP_SHARE} of the pixels")
    emit({"phase": "kernel_floor", "seconds": time.perf_counter() - t0,
          "card": card, "shapes": "street view 0 (phase render's exact "
          "binning)", "tolerance": stub_tolerance, **floor,
          "launches": launches_floor})

    # ---- 8-10. training (main path, counted) --------------------------------
    # Street production training: BENCH_street.json / tools/bench_street.py
    # :76-85.  spatial_lr_scale is the cameras' extent (1.1 x the largest
    # distance from their mean centre, as the reference's nerf++ norm).
    centres = torch.stack([c.campos for c in scene.cameras])
    extent = 1.1 * float(torch.linalg.vector_norm(
        centres - centres.mean(dim=0), dim=1).max())
    street_pipe = PipelineConfig(
        raster_method="pallas", max_dup=2, tile_capacity=128,
        dup_overscan=32, dup_tails=STREET["dup_tails"], exact_extra=9216,
        grad_reduce="counts", grad_sort="bf16")
    street_rec = train_phase("train_street", rows, scene.cameras,
                             street_pipe, STREET_STEPS, extent, dev,
                             "blend_exact_bwd", exact_counts=True)
    toy = make_toy_scene(seed=0, n=BENCH_N, n_cameras=1, width=BENCH_RES,
                         height=BENCH_RES, device=dev)
    bench_pipe = PipelineConfig(raster_method="pallas", max_dup=32,
                                tile_capacity=384, grad_reduce="sort")
    # One camera at radius 3 around the cube: extent 1.1 x 3.
    bench_rec = train_phase(
        "train_bench", (toy.means3d, toy.scales, toy.quats, toy.opacities,
                        toy.sh_coeffs), toy.cameras, bench_pipe,
        BENCH_STEPS, 3.3, dev, "blend_padded_bwd", exact_counts=False)
    loop_rec = train_loop_toy(dev)
    auto_rec = train_street_auto(dev, scene.means3d)

    # ---- 12-13. the back end: post-opt, merge, eval (main path, counted) --
    post_rec = post_opt(dev, scene, hier_path, street_pipe)
    merge_rec = merge_eval(dev, post_rec.pop("chunks"), post_rec["project"],
                           street_pipe, scene.cameras[0].campos)

    # ---- 14. the command line over a two-chunk project (main path, counted)
    ft_rec = full_train_phase(dev, scene, post_rec["project"], street_pipe)

    # ---- 15. the multi-rank layer on the card (main path, counted) --------
    par_rec = parallel_phase(dev, scene, street_pipe)

    # ---- 16. the web viewer over the street rows (main path, counted) -----
    viewer_rec = viewer_app_phase(dev, scene, hier_path)

    # ---- 17. preprocessing on a synthetic street project ------------------
    preprocess_phase(dev, card)

    # ---- 18-24. the root drivers: tools/ (main path, counted) -------------
    tools_rec = tool_phases(dev, scene)

    # ---- 18. kernels at the street shapes of view 0 -----------------------
    t0 = time.perf_counter()
    counted = {"render": launches_render, "hierarchy": launches_hier,
               "kernel_floor": launches_floor,
               "train_street": street_rec["launches"],
               "train_bench": bench_rec["launches"],
               "train_loop_toy": loop_rec["launches"],
               "train_street_auto": auto_rec["launches"],
               "post_opt": post_rec["launches"],
               "merge_eval": merge_rec["launches"],
               "full_train": ft_rec["launches"],
               "parallel": par_rec["launches"],
               "viewer_app": viewer_rec["launches"],
               **{p: r["launches"] for p, r in tools_rec.items()}}

    def launches_of(key):
        by = {p: c[key] for p, c in counted.items() if c.get(key)}
        return {"launches": sum(by.values()), "launches_by_phase": by}

    n_renders = {"blend_padded": len(scene.cameras),
                 "blend_exact": len(scene.cameras) * (1 + len(TAUS)),
                 "slab_gather": len(scene.cameras) * (2 + len(TAUS))}
    kernels = []

    ex, pd = street["exact"], street["padded"]
    for name, rec, src, replaces in (
            ("K1 blend_padded", pd, "blend_padded.cu",
             "street_sparse_3dgs_tpu/ops/pallas_blend.py:147"),
            ("K3 blend_exact", ex, "blend_exact.cu",
             "street_sparse_3dgs_tpu/ops/pallas_blend.py:439")):
        args = rec["blend"]
        exact = name.startswith("K3")
        kern = cb.blend_exact if exact else cb.blend_padded
        plain = cb.blend_exact_plain if exact else cb.blend_padded_plain
        ms = device_ms(lambda: kern(*args), 20)
        wall_ms = event_ms(lambda: kern(*args), 20)
        plain_ms = event_ms(lambda: plain(*args), 2)
        out = rec["blend_out"]
        bound_ms, bound_by, live, walk = fwd_bound(args, out, exact,
                                                   sfu_rate)
        cmp = compare_blend(out, rec["plain_out"])
        key = "blend_exact" if exact else "blend_padded"
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"street_sparse_3dgs_tpu_torch/csrc/{src}",
            "replaces": replaces, **launches_of(key),
            "launches_per_view": (launches_render[key] + launches_hier[key])
            / (n_renders[key] * (1 + TIMED_RUNS)),
            "max_abs_err": cmp["max_abs_err"],
            "pixels_over_atol": cmp["pixels_over_atol"],
            "pixels": cmp["pixels"], "flips": cmp["flips"],
            "max_err_without_flips": cmp["max_err_without_flips"],
            "tolerance": f"{IMG_ATOL} on rows RGB/invdepth/alpha/logT at "
                         f"all but {FLIP_SHARE} of the pixels",
            "ms": ms, "wall_ms": wall_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shapes": "street view 0", "live_slots": live, **walk,
            "tiles": out.shape[0], **(k3_checks(args, ms) if exact else {})})
        if exact:
            kernels[-1]["vs_split_plain"] = compare_blend(
                out, cb.blend_exact_split_plain(*args))
            check_blend("K3 street view 0 vs split plain",
                        kernels[-1]["vs_split_plain"], strict=False)

    # K1 at the train_bench shapes: the forward whose saved rows the
    # recorded K2 call read (its args minus saved and g_out).
    args = bench_rec["args"][:3] + bench_rec["args"][5:]
    out = bench_rec["args"][3]
    ms = device_ms(lambda: cb.blend_padded(*args), 20)
    cmp = compare_blend(out, cb.blend_padded_plain(*args))
    check_blend("K1 at train_bench", cmp, strict=False)
    b_ms, b_by, live, walk = fwd_bound(args, out, False, sfu_rate)
    kernels[0]["at_train_bench"] = {
        "ms": ms, "wall_ms": event_ms(lambda: cb.blend_padded(*args), 20),
        "plain_ms": event_ms(lambda: cb.blend_padded_plain(*args), 2),
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": cmp["max_abs_err"],
        "flips": cmp["flips"], "live_slots": live, **walk}

    # K2 at the train_bench shapes, K4 at the train_street view-0 shapes
    # (the inputs and output recorded in those phases' bit-identity runs).
    for name, rec, key, src, replaces, plain, shapes in (
            ("K2 blend_padded_bwd", bench_rec, "blend_padded_bwd",
             "blend_padded_bwd.cu",
             "street_sparse_3dgs_tpu/ops/pallas_blend.py:244",
             cb.blend_padded_bwd_plain, "train_bench"),
            ("K4 blend_exact_bwd", street_rec, "blend_exact_bwd",
             "blend_exact_bwd.cu",
             "street_sparse_3dgs_tpu/ops/pallas_blend.py:545",
             cb.blend_exact_bwd_plain, "train_street view 0")):
        args, out = rec["args"], rec["out"]
        kern = getattr(cb, key)
        exact = key == "blend_exact_bwd"
        ms = device_ms(lambda: kern(*args), 20)
        wall_ms = event_ms(lambda: kern(*args), 20)
        plain_ms = event_ms(lambda: plain(*args), 2)
        cmp = compare_grads(f"{name} at {shapes}", out, plain(*args),
                            2 if exact else 1)
        bound_ms, bound_by, live, walk = bwd_bound(args, exact, sfu_rate)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"street_sparse_3dgs_tpu_torch/csrc/{src}",
            "replaces": replaces, **launches_of(key),
            "max_abs_err": cmp["max_abs_err"],
            "max_scaled_err": cmp["max_scaled_err"],
            "tolerance": f"{GRAD_BAR} x max|g| per channel, on the same "
                         "saved forward rows",
            "ms": ms, "wall_ms": wall_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shapes": shapes, "live_slots": live, **walk,
            "tiles": args[5 if exact else 3].shape[0],
            **({"bit_identical_reruns": True,
                "deepest_tile": k4_checks(args, ms)} if exact
               else k2_launch_floor(args, 20, ms))})

    # K2 at the train_loop_toy shapes (its first step, 64x64, K = 128), and
    # K1 on the forward whose saved rows that K2 call read.
    args, out = loop_rec["k2_call"]
    k1_args = args[:3] + args[5:]
    cmp = compare_blend(args[3], cb.blend_padded_plain(*k1_args))
    check_blend("K1 at train_loop_toy", cmp, strict=False)
    b_ms, b_by, live, walk = fwd_bound(k1_args, args[3], False, sfu_rate)
    kernels[0]["at_train_loop_toy"] = {
        "ms": device_ms(lambda: cb.blend_padded(*k1_args), 50),
        "wall_ms": event_ms(lambda: cb.blend_padded(*k1_args), 50),
        "plain_ms": event_ms(lambda: cb.blend_padded_plain(*k1_args), 5),
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": cmp["max_abs_err"],
        "live_slots": live, **walk}
    cmp = compare_grads("K2 at train_loop_toy", out,
                        cb.blend_padded_bwd_plain(*args), 1)
    b_ms, b_by, live, walk = bwd_bound(args, False, sfu_rate)
    k2_ms = device_ms(lambda: cb.blend_padded_bwd(*args), 50)
    next(k for k in kernels if k["name"].startswith("K2"))[
        "at_train_loop_toy"] = {
        "ms": k2_ms,
        "wall_ms": event_ms(lambda: cb.blend_padded_bwd(*args), 50),
        "plain_ms": event_ms(lambda: cb.blend_padded_bwd_plain(*args), 5),
        "bound_ms": b_ms, "bound_by": b_by,
        "max_scaled_err": cmp["max_scaled_err"], "live_slots": live,
        **walk, **k2_launch_floor(args, 50, k2_ms)}

    # K3 and K4 at the train_street_auto shapes (960x544, its first resume
    # step): time, bound and agreement with the plain version there too.
    for key, plain in (("blend_exact", cb.blend_exact_plain),
                       ("blend_exact_bwd", cb.blend_exact_bwd_plain)):
        args, out = auto_rec["calls"][key]
        kern = getattr(cb, key)
        ms = device_ms(lambda: kern(*args), 20)
        plain_ms = event_ms(lambda: plain(*args), 2)
        if key == "blend_exact":
            cmp = compare_blend(out, plain(*args))
            check_blend("K3 at train_street_auto", cmp, strict=False)
            b_ms, b_by, live, walk = fwd_bound(args, out, True, sfu_rate)
        else:
            cmp = compare_grads("K4 at train_street_auto", out,
                                plain(*args), 2)
            b_ms, b_by, live, walk = bwd_bound(args, True, sfu_rate)
        entry = next(k for k in kernels if k["name"].endswith(" " + key))
        entry["at_train_street_auto"] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": cmp["max_abs_err"],
            "live_slots": live, **walk}
        if key == "blend_exact_bwd":
            entry["at_train_street_auto"]["deepest_tile"] = k4_checks(args,
                                                                      ms)
        else:
            split_cmp = compare_blend(out, cb.blend_exact_split_plain(*args))
            check_blend("K3 at train_street_auto vs split plain", split_cmp,
                        strict=False)
            entry["at_train_street_auto"].update(
                flips=cmp["flips"], vs_split_plain=split_cmp,
                **k3_checks(args, ms))

    # K3 and K4 at the post_opt shapes (chunk 0's compacted cut, 1920x1088,
    # one step at the grown capacity).
    for key, plain in (("blend_exact", cb.blend_exact_plain),
                       ("blend_exact_bwd", cb.blend_exact_bwd_plain)):
        args, out = post_rec["calls"][key]
        kern = getattr(cb, key)
        ms = device_ms(lambda: kern(*args), 20)
        if key == "blend_exact":
            cmp = compare_blend(out, plain(*args))
            check_blend("K3 at post_opt", cmp, strict=False)
            b_ms, b_by, live, walk = fwd_bound(args, out, True, sfu_rate)
        else:
            cmp = compare_grads("K4 at post_opt", out, plain(*args), 2)
            b_ms, b_by, live, walk = bwd_bound(args, True, sfu_rate)
        entry = next(k for k in kernels if k["name"].endswith(" " + key))
        entry["at_post_opt"] = {
            "ms": ms, "wall_ms": event_ms(lambda: kern(*args), 20),
            "plain_ms": event_ms(lambda: plain(*args), 2),
            "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": cmp["max_abs_err"], "live_slots": live,
            "tiles": args[3].shape[0], **walk}

    # K3 at the merge_eval shapes (the merged tree's compacted cut of the
    # test view, 1920x1088): every tau held against the plain version, tau
    # 0 (the deepest cut) timed.
    calls = merge_rec["calls"]["blend_exact"]
    per_tau = []
    for tau, (args, out) in zip(TAUS, calls, strict=True):
        cmp = compare_blend(out, cb.blend_exact_plain(*args))
        check_blend(f"K3 at merge_eval tau {tau:g}", cmp, strict=False)
        per_tau.append({"tau": tau, "max_abs_err": cmp["max_abs_err"],
                        "flips": cmp["flips"],
                        "pixels_over_atol": cmp["pixels_over_atol"],
                        "tiles": args[3].shape[0]})
    args, out = calls[0]
    b_ms, b_by, live, walk = fwd_bound(args, out, True, sfu_rate)
    next(k for k in kernels if k["name"] == "K3 blend_exact")[
        "at_merge_eval"] = {
        "ms": device_ms(lambda: cb.blend_exact(*args), 20),
        "wall_ms": event_ms(lambda: cb.blend_exact(*args), 20),
        "plain_ms": event_ms(lambda: cb.blend_exact_plain(*args), 2),
        "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": max(r["max_abs_err"] for r in per_tau),
        "timed": "tau 0", "live_slots": live, **walk, "per_tau": per_tau}
    del calls, args, out

    # K3, K4 and K5 at the full_train shapes: every stage's first call
    # held against the plain version, chunk 0's training stage timed.
    per_stage = {key: [checks[key] for checks in ft_rec["checks"].values()
                       if key in checks]
                 for key in ("blend_exact", "blend_exact_bwd", "slab_gather")}
    ft_timed = ft_rec["timed"]
    for key, plain in (("blend_exact", cb.blend_exact_plain),
                       ("blend_exact_bwd", cb.blend_exact_bwd_plain)):
        args, out = ft_timed[key]
        kern = getattr(cb, key)
        if key == "blend_exact":
            b_ms, b_by, live, walk = fwd_bound(args, out, True, sfu_rate)
        else:
            b_ms, b_by, live, walk = bwd_bound(args, True, sfu_rate)
        next(k for k in kernels if k["name"].endswith(" " + key))[
            "at_full_train"] = {
            "ms": device_ms(lambda: kern(*args), 20),
            "wall_ms": event_ms(lambda: kern(*args), 20),
            "plain_ms": event_ms(lambda: plain(*args), 2),
            "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": max(r["max_abs_err"] for r in per_stage[key]),
            "timed": "chunk_0_0_train, first step", "live_slots": live,
            **walk, "per_stage": per_stage[key]}

    # K1-K4 at the parallel shapes: each rank's first call (K1 at tile0 >
    # 0, K1 at t_mod with per-tile backgrounds, K3 over a rank's order, K3
    # at t_mod, their backwards) held against the plain version in the rank.
    for prefix, keys in (("K1 ", ("K1 tile0 > 0", "K1 t_mod, per-tile bg")),
                         ("K2 ", ("K2 tile0 > 0", "K2 t_mod, per-tile bg")),
                         ("K3 ", ("K3 order", "K3 t_mod")),
                         ("K4 ", ("K4 order", "K4 t_mod"))):
        next(k for k in kernels if k["name"].startswith(prefix))[
            "at_parallel"] = {key[3:]: par_rec["held"][key] for key in keys}

    # K1 at the viewer_app shapes (the first request's call: tau 0 of the
    # street hierarchy at 1920x1088, RasterConfig(method="pallas")), every
    # request's K1 held against the plain version in the phase.
    args, out = viewer_rec["calls"]["blend_padded"]
    cmp = compare_blend(out, cb.blend_padded_plain(*args))
    check_blend("K1 at viewer_app", cmp, strict=False)
    b_ms, b_by, live, walk = fwd_bound(args, out, False, sfu_rate)
    kernels[0]["at_viewer_app"] = {
        "ms": device_ms(lambda: cb.blend_padded(*args), 20),
        "wall_ms": event_ms(lambda: cb.blend_padded(*args), 20),
        "plain_ms": event_ms(lambda: cb.blend_padded_plain(*args), 2),
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": cmp["max_abs_err"],
        "flips": cmp["flips"], "timed": "tau 0, first request",
        "tiles": args[0].shape[0], "k": args[0].shape[2],
        "live_slots": live, **walk,
        "held": {name: [c["max_abs_err"] for c in h["K1"]]
                 for name, h in viewer_rec["held"].items()}}
    del args, out

    def k5_timing(k5_args, k5_out) -> dict:
        """K5 on a recorded call: device and wall ms, the plain version's,
        the byte bound (live keys read, starts and counts, the table
        written) and the library call ``padded[starts + arange(K)]``."""
        sorted_vals, starts, counts_v, k_cap = k5_args[:4]
        padded = torch.cat([sorted_vals, torch.zeros(
            k_cap, dtype=torch.int64, device=dev)])
        idx = (starts.to(torch.int64)[:, None]
               + torch.arange(k_cap, device=dev)[None, :])
        live = int(torch.clamp(counts_v, max=k_cap).sum())
        k5_bytes = (live * 8 + starts.shape[0] * 8
                    + starts.shape[0] * k_cap * 4)
        return {"ms": device_ms(lambda: binning.slab_gather(*k5_args), 50),
                "wall_ms": event_ms(lambda: binning.slab_gather(*k5_args),
                                    50),
                "plain_ms": event_ms(
                    lambda: binning.slab_gather_plain(*k5_args), 5),
                "bound_ms": k5_bytes / PEAK_BYTES_S * 1e3,
                "bound_by": "bytes",
                "library_ms": device_ms(lambda: padded[idx], 50),
                "library_wall_ms": event_ms(lambda: padded[idx], 50),
                "max_abs_err": float((k5_out - binning.slab_gather_plain(
                    *k5_args)).abs().max()),
                "rows": starts.shape[0], "k": k_cap, "live_slots": live}

    k5 = k5_timing(ex["k5"], ex["k5_out"])
    k5_post = k5_timing(*post_rec["calls"]["slab_gather"])
    k5_calls = merge_rec["calls"]["slab_gather"]
    if len(k5_calls) != len(TAUS):
        raise AssertionError(f"K5: {len(k5_calls)} calls in merge_eval")
    k5_merge = k5_timing(*k5_calls[0])
    k5_merge["timed"] = "tau 0"
    k5_merge["max_abs_err"] = max(float((o - binning.slab_gather_plain(
        *a)).abs().max()) for a, o in k5_calls)
    k5_ft = k5_timing(*ft_timed["slab_gather"])
    k5_viewer = k5_timing(*viewer_rec["calls"]["slab_gather"])
    k5_viewer["timed"] = "tau 0, first request"
    k5_ft.update(timed="chunk_0_0_train, first step",
                 per_stage=per_stage["slab_gather"])
    if k5["max_abs_err"] or k5_post["max_abs_err"] or \
            k5_merge["max_abs_err"] or k5_viewer["max_abs_err"]:
        raise AssertionError("K5: kernel table differs from plain")
    del post_rec, merge_rec, k5_calls, ft_rec, ft_timed, viewer_rec
    kernels.append({
        "name": "K5 slab_gather", "route": "cuda",
        "source": "street_sparse_3dgs_tpu_torch/csrc/slab_gather.cu",
        "replaces": "street_sparse_3dgs_tpu/ops/binning.py:159",
        **launches_of("slab_gather"),
        "launches_per_view": (launches_render["slab_gather"]
                              + launches_hier["slab_gather"])
        / (n_renders["slab_gather"] * (1 + TIMED_RUNS)),
        "tolerance": "exactly equal", **k5, "shapes": "street view 0",
        "at_post_opt": k5_post, "at_merge_eval": k5_merge,
        "at_full_train": k5_ft, "at_viewer_app": k5_viewer})
    # bin_scan on view 0's projected rows (the exact config; the padded
    # config's call, the same rows and scan, was held in phase render).
    # ``ms`` is the kernel alone on the wrapper's cap; ``wall_ms`` the
    # wrapper (the cap's [N] ops and its pageable copy, host cost included).
    bs_args, bs_out = ex["scan"], ex["scan_out"]
    mean2d, conic, radius, opacity, valid, tiles_x, tiles_y, scan = bs_args
    n_rows = mean2d.shape[0]
    qcap = binning._qcap(opacity)
    kept_k, cov_k, tid_k = (torch.empty_like(x) for x in bs_out)

    def bin_scan_kernel():
        native.launch("bin_scan", mean2d.data_ptr(), conic.data_ptr(),
                      radius.data_ptr(), valid.data_ptr(), qcap.data_ptr(),
                      n_rows, tiles_x, tiles_y, scan, kept_k.data_ptr(),
                      cov_k.data_ptr(), tid_k.data_ptr())

    bs_ms = device_ms(bin_scan_kernel, 50)
    if not all(torch.equal(a, b) for a, b in zip((kept_k, cov_k, tid_k),
                                                 bs_out)):
        raise AssertionError("bin_scan: a bare launch differs from the "
                             "wrapper's")
    # Bytes: mean2d, conic, radius, valid and qcap read once, kept,
    # coverage and the [N, scan] table written once.
    bs_bytes = n_rows * (8 + 12 + 4 + 1 + 4 + 4 + 4 + 4 * scan)
    plain_out = binning.bin_scan_plain(*bs_args)
    kernels.append({
        "name": "bin_scan", "route": "cuda",
        "source": "street_sparse_3dgs_tpu_torch/csrc/bin_scan.cu",
        "replaces": "none (ops/binning.py bin_scan_plain: the [N, S] slot "
                    "scan and the per-row tile sort)",
        **launches_of("bin_scan"),
        "tolerance": "exactly equal (kept, coverage, tile_id)",
        "max_abs_err": max(int((a - b).abs().max()) if a.numel() else 0
                           for a, b in zip(bs_out, plain_out)),
        "ms": bs_ms,
        "wall_ms": event_ms(lambda: binning.bin_scan(*bs_args), 50),
        "plain_ms": event_ms(lambda: binning.bin_scan_plain(*bs_args), 5),
        "bound_ms": bs_bytes / PEAK_BYTES_S * 1e3, "bound_by": "bytes",
        "library_ms": None, "shapes": "street view 0 (exact config)",
        "rows": n_rows, "scan": scan,
        "covered_slots": int(torch.clamp(bs_out[1], max=scan).sum()),
        "kept_slots": int(bs_out[0].sum())})
    if kernels[-1]["max_abs_err"]:
        raise AssertionError("bin_scan: kernel differs from plain")
    del bs_args, bs_out, plain_out, qcap, kept_k, cov_k, tid_k
    kernels += project_kernels(rows, scene.cameras[0], launches_of)
    # K1-K5 at the tools' shapes (phases 18-24): each phase's first call of
    # each kernel held against the plain version, timed and bounded.
    for phase, rec in tools_rec.items():
        for name, (args, out) in rec["calls"].items():
            key, _, run = name.partition("@")
            if key == "slab_gather":
                held = k5_timing(args, out)
                if held["max_abs_err"]:
                    raise AssertionError(f"K5 at {phase}: table differs")
            else:
                held = tool_held(key, args, out, sfu_rate, phase)
            entry = next(k for k in kernels if k["name"].endswith(" " + key))
            entry[f"at_{phase}" + (f"_{run}" if run else "")] = held
    del tools_rec
    # D1-D3 at the street shapes of the kernel_floor phase: the headline
    # variant (level 2; D3 one tile a block) and every variant beside it.
    for probe, replaces in (("D1", "tools/kernel_floor_tpu.py:40"),
                            ("D2", "tools/kernel_floor_tpu.py:113"),
                            ("D3", "tools/kernel_floor_tpu.py:317")):
        recs = [r for r in floor["stubs"] if r["probe"] == probe]
        head = recs[0]
        n_launch = sum(r["launches"] for r in recs)
        kernels.append({
            "name": f"{probe} blend_exact_stub", "route": "cuda",
            "source": "street_sparse_3dgs_tpu_torch/csrc/blend_exact_stub.cu",
            "replaces": replaces, "launches": n_launch,
            "launches_by_phase": {"kernel_floor": n_launch},
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "max_err_over_sum_terms": max(r["max_err_over_sum_terms"]
                                          for r in recs),
            "tolerance": stub_tolerance,
            "ms": head["ms"], "wall_ms": head["wall_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None, "shapes": "street view 0",
            "headline": (f"level {head['level']}, {head['layout']}, "
                         f"{head['tiles_per_block']} table row(s) a block, "
                         f"group {head['group']}"),
            "variants": recs})
    torch.cuda.synchronize()
    emit({"phase": "kernels_street", "seconds": time.perf_counter() - t0,
          "card": card})

    print(card, flush=True)
    emit({"kernels": kernels})
    print(json.dumps({"phase": "total",
                      "seconds": time.perf_counter() - t_all}),
          file=sys.stderr, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
