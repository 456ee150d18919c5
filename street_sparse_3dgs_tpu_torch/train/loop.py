"""Host-side training loop, mirroring ``street_sparse_3dgs_tpu/train/
loop.py``: it drives the step (``train.step``) over a camera stream and
applies the cadenced side effects of the reference (``train_single.py:
186-241``):

- densify + prune every ``densification_interval`` steps inside
  (``densify_from_iter``, ``densify_until_iter``), growing the capacity x2
  when new rows do not fit (never dropping them);
- opacity reset every ``opacity_reset_interval`` (and once at
  ``densify_from_iter`` on white backgrounds), with the opacity moments
  zeroed;
- the big-Gaussian clamp, fused into the step;
- in exact mode, growth of the window budget ``exact_extra`` when a step
  overflowed it;
- self-sizing: ``exact_extra == -1`` is resolved into measured knobs
  (``autosize_pipeline``, ``ops/autosize``) before the first step and again
  after every capacity growth; ``stats["final_pipe"]`` holds the resolved
  config;
- the GT point-cloud constraint: with a ``gt_index``
  (``models/gt_constraint``), each densify round also prunes the rows it
  finds too far from the GT cloud;
- checkpoints at ``hooks.checkpoint_iterations``: the ``on_checkpoint``
  hook, or without one ``model_path/chkpnt{it}.npz``
  (``models/serialize.save_checkpoint``);
- the live viewer: ``hooks.viewer_poll`` (``viewer/hook.ViewerHook``) at
  the top of every iteration, with the state before the step and the
  previous step's background.

The budget grows from the LARGEST single-step ``tile_overflow`` since the
last check (a running ``torch.maximum`` on the device), not from the sum of
the overflows over the check window, which overshoots after a burst of
overflowing steps.
"""

from __future__ import annotations

import dataclasses
import itertools
from pathlib import Path
from typing import Callable, Iterable

import torch

from ..config import ModelConfig, OptimizationConfig, PipelineConfig
from ..models import adam, densify
from ..models.gaussians import (GaussianMeta, GaussianParams,
                                activate_opacity, activate_scales, sh_coeffs)
from ..models.gt_constraint import too_far_mask
from ..models.serialize import save_checkpoint
from ..ops import autosize
from ..utils import EmaMeter
from .step import CameraBatch, TrainState, make_train_step


def densify_state(state: TrainState, noise: torch.Tensor, meta: GaussianMeta,
                  grad_threshold: float, min_opacity: float, extent: float,
                  percent_dense: float,
                  extra_prune: torch.Tensor | None = None):
    """One densify/prune round on a train state: (new state, n_active,
    overflow).  ``extra_prune`` [C] marks more rows to prune."""
    res = densify.densify_and_prune(
        noise, state.params, state.active, state.adam_state,
        densify.DensifyState(state.grad_accum, state.denom,
                             state.max_radii2d),
        meta, grad_threshold, min_opacity, extent, percent_dense,
        extra_prune=extra_prune)
    return (state._replace(params=res.params, active=res.active,
                           adam_state=res.adam_state,
                           grad_accum=res.densify_state.grad_accum,
                           denom=res.densify_state.denom,
                           max_radii2d=res.densify_state.max_radii2d),
            res.n_active, res.overflow)


def reset_opacity_state(state: TrainState, meta: GaussianMeta) -> TrainState:
    """Opacity reset with the opacity rows' Adam moments zeroed (the
    reference's ``replace_tensor_to_optimizer``)."""
    a = state.adam_state
    return state._replace(
        params=densify.reset_opacity(state.params, meta),
        adam_state=a._replace(
            mu=a.mu._replace(opacity_raw=torch.zeros_like(a.mu.opacity_raw)),
            nu=a.nu._replace(opacity_raw=torch.zeros_like(
                a.nu.opacity_raw))))


def grow_capacity(state: TrainState, meta: GaussianMeta,
                  new_capacity: int) -> tuple[TrainState, GaussianMeta]:
    """Pad every capacity-indexed tensor with inactive rows."""
    old = meta.capacity
    pad = new_capacity - old
    if pad <= 0:
        return state, meta

    def pad_rows(a, fill=0.0):
        if a.dim() == 0 or a.shape[0] != old:
            return a
        return torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), fill,
                                        dtype=a.dtype, device=a.device)])

    def pad_params(p: GaussianParams) -> GaussianParams:
        out = GaussianParams(*(pad_rows(leaf) for leaf in p))
        quats = out.quats.clone()
        quats[old:, 0] = 1.0
        log_scales, opacity = out.log_scales.clone(), out.opacity_raw.clone()
        log_scales[old:] = -10.0
        opacity[old:] = -10.0
        return out._replace(quats=quats, log_scales=log_scales,
                            opacity_raw=opacity)

    new_state = state._replace(
        params=pad_params(state.params),
        active=pad_rows(state.active, False),
        adam_state=adam.AdamState(
            mu=GaussianParams(*(pad_rows(x) for x in state.adam_state.mu)),
            nu=GaussianParams(*(pad_rows(x) for x in state.adam_state.nu)),
            step=state.adam_state.step),
        grad_accum=pad_rows(state.grad_accum),
        denom=pad_rows(state.denom),
        max_radii2d=pad_rows(state.max_radii2d))
    return new_state, dataclasses.replace(meta, capacity=new_capacity)


def grown_budget(exact_extra: int, max_step_overflow: int,
                 tile_capacity: int) -> int:
    """The window budget after a check that saw ``max_step_overflow`` pair
    slots lost by the worst single step: at least double, and enough extra
    K-wide windows for that step, rounded up to a multiple of 128."""
    grown = max(exact_extra * 2,
                exact_extra + -(-max_step_overflow // tile_capacity))
    return -(-grown // 128) * 128


def autosize_pipeline(pipe: PipelineConfig, state: TrainState,
                      meta: GaussianMeta, batches,
                      max_views: int = 8) -> PipelineConfig:
    """Resolve ``exact_extra == -1`` (self-sizing) into measured knobs: the
    emission ladder and window budget of ``ops/autosize.autosize_raster``
    over the first ``max_views`` cameras of ``batches``, which must be
    re-iterable (a list): sampling a one-shot iterator would take its first
    views from the training stream.  The scan window is bounded by the
    capacity, so the [capacity, S] emission arrays stay near 2^28
    elements."""
    if iter(batches) is batches:
        raise TypeError("autosize needs a re-iterable batch stream (such as "
                        "a list), not an iterator: sampling would consume "
                        "its first views")
    sample = list(itertools.islice(iter(batches), max_views))
    if not sample:
        raise ValueError("autosize: empty batch stream")
    cams = [b.camera for b in sample]
    cap_max = int(min(256, max(32, (1 << 28) // meta.capacity)))
    knobs = autosize.autosize_raster(
        state.params.xyz, activate_scales(state.params), state.params.quats,
        activate_opacity(state.params, meta), sh_coeffs(state.params), cams,
        meta.sh_degree, cams[0].height, cams[0].width, pipe.tile_capacity,
        max_dup=0, active_mask=state.active, scan_cap_max=cap_max)
    print(f"  autosized exact mode: max_dup={knobs.max_dup} "
          f"overscan={knobs.dup_overscan} tails={knobs.dup_tails} "
          f"exact_extra={knobs.exact_extra} "
          f"(measured extras={knobs.expected_extras}, "
          f"dup_of={knobs.expected_dup_overflow})")
    return dataclasses.replace(
        pipe, max_dup=knobs.max_dup, dup_overscan=knobs.dup_overscan,
        dup_tails=knobs.dup_tails, exact_extra=knobs.exact_extra)


@dataclasses.dataclass
class LoopHooks:
    """Optional host callbacks (progress, checkpointing, network GUI)."""

    on_step: Callable | None = None          # (it, state, aux) -> None
    on_densify: Callable | None = None       # (it, n_active) -> None
    checkpoint_iterations: tuple = ()
    on_checkpoint: Callable | None = None    # (it, state, meta) -> None
    # Live viewer: a ViewerHook (viewer/hook.py), polled at the top of every
    # iteration with the current state like the reference
    # (``train_single.py:80-97``).
    viewer_poll: Callable | None = None      # (state, meta, done, bg) -> bool


def train_loop(
    state: TrainState,
    meta: GaussianMeta,
    batches: Iterable[CameraBatch],
    opt: OptimizationConfig,
    pipe: PipelineConfig,
    model_cfg: ModelConfig,
    cameras_extent: float,
    spatial_lr_scale: float,
    *,
    iterations: int | None = None,
    densify_enabled: bool = True,
    clamp_fraction: float = 0.02,
    coarse_mode: bool = False,
    rng_seed: int = 0,
    hooks: LoopHooks = LoopHooks(),
    gt_index=None,
) -> tuple[TrainState, GaussianMeta, dict]:
    """Run the optimisation loop over ``batches`` (re-iterated when
    exhausted) for ``iterations`` steps.  Random draws (backgrounds, split
    noise) come from generators seeded with ``rng_seed`` on the state's
    device.  ``gt_index`` (``models.gt_constraint.GtIndex``) adds the GT
    point-cloud prune to every densify round.  Returns (state, meta,
    stats)."""
    iterations = iterations or opt.iterations
    dev = state.params.xyz.device
    noise_gen = torch.Generator(device=dev).manual_seed(rng_seed)
    bg_gen = torch.Generator(device=dev).manual_seed(rng_seed + 17)

    auto_mode = pipe.raster_method == "pallas" and pipe.exact_extra == -1
    if auto_mode:
        # Resolved before exact_on is read: a self-sized run checks its
        # budget like any exact run.
        pipe = autosize_pipeline(pipe, state, meta, batches)

    ema = EmaMeter()
    progress_every = max(1, min(500, iterations // 10))
    exact_on = pipe.raster_method == "pallas" and pipe.exact_extra > 0
    check_every = min(100, progress_every) if exact_on else progress_every

    fold_clamp = not model_cfg.skip_scale_big_gauss
    clamp_frac = 0.1 if coarse_mode else clamp_fraction

    def build_step(meta_, depth_only: bool):
        kw = dict(use_trained_exp=not coarse_mode,
                  optimize_xyz=not coarse_mode,
                  zero_scaling_grads_for_skybox=coarse_mode)
        if depth_only:
            kw = {}
        return make_train_step(
            meta_, opt, pipe, spatial_lr_scale, is_depth_only=depth_only,
            additional_depth_maps_weight=(
                model_cfg.additional_depth_maps_weight),
            clamp_extent=float(cameras_extent) if fold_clamp else None,
            clamp_fraction=clamp_frac, random_background=True,
            white_background=model_cfg.white_background,
            bg_generator=bg_gen, **kw)

    steps = {}

    def step_for(depth_only: bool):
        if depth_only not in steps:
            steps[depth_only] = build_step(meta, depth_only)
        return steps[depth_only]

    stats = {"losses": [], "n_active": [], "overflows": 0,
             "exact_growths": 0, "skipped_updates": 0}
    pending_losses: list = []

    def drain_losses():
        if pending_losses:
            stats["losses"].extend(torch.stack(pending_losses).tolist())
            pending_losses.clear()

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    dup_acc, tile_acc, skip_acc, tile_max = zero, zero, zero, zero
    it = 0
    last_bg = None
    batch_iter = iter(batches)
    while it < iterations:
        try:
            batch = next(batch_iter)
        except StopIteration:
            batch_iter = iter(batches)
            batch = next(batch_iter)
        it += 1

        if hooks.viewer_poll is not None:
            hooks.viewer_poll(state, meta, it >= iterations, last_bg)

        step = step_for(bool(getattr(batch, "is_depth_only", False)))
        state, aux = step(state, batch)
        last_bg = aux.get("bg")
        if hooks.on_step is not None:
            hooks.on_step(it, state, aux)
        # Counters stay on the device; the host reads them at the check
        # and progress cadence only.
        pending_losses.append(aux["loss"])
        dup_acc = dup_acc + aux["dup_overflow"]
        tile_acc = tile_acc + aux["tile_overflow"]
        tile_max = torch.maximum(tile_max, aux["tile_overflow"])
        if "update_skipped" in aux:
            skip_acc = skip_acc + aux["update_skipped"]
        if exact_on and it % check_every == 0:
            worst = int(tile_max)
            if worst > 0:
                grown = grown_budget(pipe.exact_extra, worst,
                                     pipe.tile_capacity)
                print(f"  exact window budget overflow (worst step lost "
                      f"{worst} pair slots): growing exact_extra "
                      f"{pipe.exact_extra} -> {grown}")
                pipe = dataclasses.replace(pipe, exact_extra=grown)
                stats["exact_growths"] += 1
                steps.clear()
            tile_max = zero
        if it % progress_every == 0:
            drain_losses()
            ema.update(stats["losses"][-1])
            print(f"  it {it}/{iterations} loss(ema) {ema.value:.5f} "
                  f"visible {int(aux['n_visible'])}")
            dup, tile = int(dup_acc), int(tile_acc)
            if dup or tile:
                print(f"  WARNING: binning overflow since start dup={dup} "
                      f"tile={tile} (rendered image is missing "
                      "contributions; raise max_dup/tile_capacity)")

        if (densify_enabled and it < opt.densify_until_iter
                and it > opt.densify_from_iter
                and it % opt.densification_interval == 0):
            noise = torch.randn((2, meta.capacity, 3), generator=noise_gen,
                                device=dev)
            extra_prune = None
            if gt_index is not None:
                extra_prune = too_far_mask(gt_index, state.params.xyz,
                                           state.active)
            state, n_active, overflow = densify_state(
                state, noise, meta, opt.densify_grad_threshold, 0.005,
                float(cameras_extent), opt.percent_dense, extra_prune)
            overflow = int(overflow)
            if overflow > 0:
                stats["overflows"] += 1
                state, meta = grow_capacity(
                    state, meta, max(meta.capacity * 2,
                                     meta.capacity + overflow))
                if auto_mode:
                    # Densification moved the splat sizes and the capacity
                    # bound of the scan window: measure the knobs again.
                    pipe = autosize_pipeline(pipe, state, meta, batches)
                steps.clear()
            stats["n_active"].append(int(n_active))
            if hooks.on_densify is not None:
                hooks.on_densify(it, int(n_active))

        if (densify_enabled and it < opt.densify_until_iter
                and (it % opt.opacity_reset_interval == 0
                     or (model_cfg.white_background
                         and it == opt.densify_from_iter))):
            state = reset_opacity_state(state, meta)

        if it in hooks.checkpoint_iterations:
            if hooks.on_checkpoint is not None:
                hooks.on_checkpoint(it, state, meta)
            elif model_cfg.model_path:
                save_checkpoint(Path(model_cfg.model_path)
                                / f"chkpnt{it}.npz", state, meta, it)

    drain_losses()
    stats["dup_overflow"] = int(dup_acc)
    stats["tile_overflow"] = int(tile_acc)
    stats["skipped_updates"] = int(skip_acc)
    stats["final_pipe"] = pipe
    if stats["dup_overflow"] or stats["tile_overflow"]:
        print(f"  WARNING: binning overflow over the run "
              f"dup={stats['dup_overflow']} tile={stats['tile_overflow']}")
    return state, meta, stats
