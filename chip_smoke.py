#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's forward LOD render path, its training path and its
street-scale tools path on the card and holds every hand-written kernel
against its plain PyTorch version:

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
             plain path on the same inputs;
5. hierarchy — a LOD hierarchy over the same rows, saved to ``.hier.npz``
             and loaded back, rendered per view at tau in {0, 3, 6, 15}
             through ``pixel_limit -> select_cut -> render_cut_compact``;
6. layers  — the stages of one street render timed apart, and a profile
             of it (device time by op, device idle share);
7. kernel_floor — ``tools/kernel_floor``'s measurements on phase 4's view-0
             exact binning: the real K3 (with and without its split)
             against the stubs on K3's own kernels, D1 (channel-major,
             levels 2..-2), D2 (pair-major, levels 2, 0, -1), D3 (level
             0, 1/2/4/8 table rows a block) and D1, D2 level 2 without the
             split, each held against its plain version, and the
             mechanics / loads split, each field named for the probe and
             layout it reads (no math share: level 2 is heavier than K3's
             walk);
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
12. kernels_street — K1-K5 timed at the shapes of phases 4, 8, 9, and K3,
             K4 at those of phase 11, K1 at phase 9's, K2 at phase 10's:
             ``ms`` is device time (``profiling.device_ms``), ``wall_ms``
             the events around back-to-back calls, host cost included; K2
             beside its launch floor (the same call with every count 0); K3
             and K4 launched twice (bit-identical) and over their deepest
             tile alone (its share of the launch); K1-K4: the walked and
             the passing (slot, pixel) steps and the share of walked
             warp-slots where a pixel passes the alpha test, from which
             the bound is counted; K3 also deepest first, and against the
             split's plain twin;
13. the kernels line (launches counted on phases 4, 5, 7, 8, 9, 10 and 11
             only, error against the plain version, times, bound) and the
             device line.

Every phase prints one JSON line.  Any failure raises and exits nonzero.
Without a CUDA card it exits 1 before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import math
import shutil
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM special-function rate (NVIDIA data sheet; the memory and f32
# peaks are profiling.PEAK_BYTES_S / PEAK_FLOP_S).
SFU_PER_SM_PER_CLK = 16          # special-function results per SM per clock
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
AUTO_SLICE, RESUME_STEPS = 180, 10       # train_street_auto
K5_EDGE_KS = (128, 384, 1024, 100)


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
    graph outlives its step."""

    def __init__(self, module, name: str, first_only: bool = False):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.first_only = first_only
        self.calls: list = []

    def __enter__(self):
        # Keyword arguments (a launch ``order``) pass through unrecorded.
        def wrapped(*args, **kw):
            out = self.fn(*args, **kw)
            if not self.first_only:
                self.calls.append((args, out))
            elif not self.calls:
                self.calls.append((tuple(
                    x.detach() if isinstance(x, torch.Tensor) else x
                    for x in args), out.detach()))
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


def step_stages(step, state, batch, bg, bwd_name: str) -> dict:
    """Device-time split of one training step by CUDA events: set-up,
    forward (render + loss), the backward blend kernel, the slot->row
    reduction, the rest of the backward, and what follows the grads (masks,
    Adam, exposure Adam, densify statistics)."""
    from street_sparse_3dgs_tpu_torch.ops import cuda_blend as cb

    def ev():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    spans = {bwd_name: [], "slot_grads_to_rows": []}
    originals = {k: getattr(cb, k) for k in spans}
    marks = {}

    def timed(key):
        def wrapped(*args, **kw):
            s = ev()
            out = originals[key](*args, **kw)
            spans[key].append((s, ev()))
            return out
        return wrapped

    fwd, vag = step.forward, step.value_and_grad

    def forward(*args):
        marks["fwd0"] = ev()
        out = fwd(*args)
        marks["fwd1"] = ev()
        return out

    def value_and_grad(*args):
        out = vag(*args)
        marks["bwd1"] = ev()
        return out

    for k in spans:
        setattr(cb, k, timed(k))
    step.forward, step.value_and_grad = forward, value_and_grad
    torch.cuda.synchronize()
    marks["start"] = ev()
    step(state, batch, bg=bg)
    marks["end"] = ev()
    torch.cuda.synchronize()
    for k, fn in originals.items():
        setattr(cb, k, fn)
    del step.forward, step.value_and_grad

    def el(a, b):
        return a.elapsed_time(b)

    kern = sum(el(s, e) for s, e in spans[bwd_name])
    red = sum(el(s, e) for s, e in spans["slot_grads_to_rows"])
    bwd = el(marks["fwd1"], marks["bwd1"])
    return {"setup": el(marks["start"], marks["fwd0"]),
            "forward": el(marks["fwd0"], marks["fwd1"]),
            bwd_name: kern, "slot_grads_to_rows": red,
            "backward_rest": bwd - kern - red,
            "adam_and_stats": el(marks["bwd1"], marks["end"]),
            "total": el(marks["start"], marks["end"])}


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
                   total, cb._chunk_tiles(s, e, dev, t_mod))
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
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    max_mhz = float(smi("clocks.max.sm").split()[0])
    sfu_rate = sm_count * SFU_PER_SM_PER_CLK * max_mhz * 1e6
    emit({"phase": "build", "seconds": info["seconds"],
          "built": info["built"], "ptxas": info["ptxas"], "card": card,
          "sms": sm_count, "max_sm_mhz": max_mhz})

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
    # kf.SUM_RTOL of each pixel's sum of |terms|).
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
        for level in kf.LEVELS_D1:
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
    for name in ("blend_padded", "blend_exact", "slab_gather"):
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
                Recorder(cb, blend_name) as kb:
            again = rasterize(*rows, cam, 3, bg, cfg)
        k5_args, k5_out = k5.calls[0]
        if not torch.equal(k5_out, binning.slab_gather_plain(*k5_args)):
            raise AssertionError(f"K5 view {v} {cname}: table differs")
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
                                 blend_out=b_out, plain_out=p_out)
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
    path = ROOT / "build" / "smoke" / "street.hier.npz"
    save_hierarchy(path, h)
    h2 = load_hierarchy(path, device=dev)
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
    emit({"phase": "kernel_floor", "seconds": time.perf_counter() - t0,
          "card": card, "shapes": "street view 0 (phase render's exact "
          "binning)", "tolerance": f"levels 0, -1, -2 equal; levels 2, 1 "
          f"within {kf.SUM_RTOL} x sum|terms| per pixel", **floor,
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

    # ---- 12. kernels at the street shapes of view 0 -----------------------
    t0 = time.perf_counter()
    counted = {"render": launches_render, "hierarchy": launches_hier,
               "kernel_floor": launches_floor,
               "train_street": street_rec["launches"],
               "train_bench": bench_rec["launches"],
               "train_loop_toy": loop_rec["launches"],
               "train_street_auto": auto_rec["launches"]}

    def launches_of(key):
        by = {p: c[key] for p, c in counted.items() if c[key]}
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

    k5_args = ex["k5"]
    sorted_vals, starts, counts_v, k_cap = k5_args[:4]
    ms = device_ms(lambda: binning.slab_gather(*k5_args), 50)
    wall_ms = event_ms(lambda: binning.slab_gather(*k5_args), 50)
    plain_ms = event_ms(lambda: binning.slab_gather_plain(*k5_args), 5)
    padded = torch.cat([sorted_vals, torch.zeros(k_cap, dtype=torch.int64,
                                                 device=dev)])
    idx = (starts.to(torch.int64)[:, None]
           + torch.arange(k_cap, device=dev)[None, :])
    library_ms = device_ms(lambda: padded[idx], 50)
    library_wall_ms = event_ms(lambda: padded[idx], 50)
    live = int(torch.clamp(counts_v, max=k_cap).sum())
    k5_bytes = live * 8 + starts.shape[0] * 8 + starts.shape[0] * k_cap * 4
    kernels.append({
        "name": "K5 slab_gather", "route": "cuda",
        "source": "street_sparse_3dgs_tpu_torch/csrc/slab_gather.cu",
        "replaces": "street_sparse_3dgs_tpu/ops/binning.py:159",
        **launches_of("slab_gather"),
        "launches_per_view": (launches_render["slab_gather"]
                              + launches_hier["slab_gather"])
        / (n_renders["slab_gather"] * (1 + TIMED_RUNS)),
        "max_abs_err": float((ex["k5_out"] - binning.slab_gather_plain(
            *k5_args)).abs().max()),
        "tolerance": "exactly equal",
        "ms": ms, "wall_ms": wall_ms, "plain_ms": plain_ms,
        "bound_ms": k5_bytes / PEAK_BYTES_S * 1e3, "bound_by": "bytes",
        "library_ms": library_ms, "library_wall_ms": library_wall_ms,
        "shapes": "street view 0",
        "rows": starts.shape[0], "k": k_cap, "live_slots": live})
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
            "tolerance": f"levels 0, -1, -2 equal; levels 2, 1 within "
                         f"{kf.SUM_RTOL} x sum|terms| per pixel",
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
