"""Data-parallel training step over the views of a batch, mirroring
``street_sparse_3dgs_tpu/parallel/dp.py``.

The execution model: a rank is a process with one explicit
``torch.device`` (``parallel/mesh.py``); the collectives go through
``parallel/collectives.py``.  Parameters are replicated; each data rank
renders its B / n_data views with the serial ``rasterize`` and
backpropagates the sum of their losses over B.  Then, in one collective
each:

- SUM over the data ranks of the parameter and exposure grads, the loss,
  ``denom`` and the overflow counters;
- MAX of the visibility union, the screen-grad norm and the radii
  (``dp.py:166-176``: per-row max over views, as accumulating the views
  serially would).

The masked sparse Adam (``relevant`` from the reduced opacity grad) and the
exposure Adam then run replicated, identically on every rank.  Depth-only
views in a mixed batch (``depth_flags``) contribute the hinge + pure depth
loss instead of the photometric one (``dp.py:78-97``).  Random draws are
inputs: the step takes this rank's [b, 3] backgrounds (JAX folds the step
into a key per view, ``dp.py:132-135``).

Everything but the reductions is the serial step's (``train/step.py``):
the schedules, the per-view loss, the grad masking, the update and the
densify statistics, as ``tp.py`` and ``ring.py`` take them too.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..config import OptimizationConfig, PipelineConfig
from ..models import densify
from ..models.gaussians import GaussianMeta, GaussianParams
from ..ops.rasterize import rasterize
from ..train import losses
from ..train.step import (CameraBatch, TrainState, grads_or_zeros,
                          leaf_params, mask_grads, raster_config,
                          render_args, schedules, update, view_loss)
from .collectives import all_reduce_flat
from .mesh import Mesh, data_shard, replicate_state


def make_dp_train_step(
    meta: GaussianMeta,
    opt: OptimizationConfig,
    pipe: PipelineConfig,
    spatial_lr_scale: float,
    mesh: Mesh,
    *,
    use_trained_exp: bool = True,
    optimize_xyz: bool = True,
    zero_scaling_grads_for_skybox: bool = False,
    additional_depth_maps_weight: float = 0.9,
):
    """Returns ``(step_fn, shard_batch, shard_state)``.

    ``step_fn(state, views, bgs, active_sh=None, depth_flags=None) ->
    (state, aux)`` takes THIS rank's views (``shard_batch`` of the batch's
    list of ``CameraBatch``), their backgrounds [b, 3] and depth-only
    flags (b bools); every data rank holds the same number b, so the batch
    is B = b · n_data.  ``aux``: the batch-mean loss, ``n_visible`` and the
    overflow counters summed over the batch.  ``shard_state`` replicates a
    ``TrainState`` from rank 0."""
    cfg = raster_config(pipe)
    group = mesh.group("data")
    n_data = mesh.size("data")
    losses.tf32_off()

    def step_fn(state: TrainState, views: Sequence[CameraBatch],
                bgs: torch.Tensor, active_sh: int | None = None,
                depth_flags: Sequence[bool] | None = None):
        active_sh = meta.sh_degree if active_sh is None else active_sh
        it = int(state.step) + 1
        xyz_lr, exp_lr, depth_w = schedules(opt, it, spatial_lr_scale,
                                            optimize_xyz)
        b_total = len(views) * n_data
        flags = ([False] * len(views) if depth_flags is None
                 else [bool(f) for f in depth_flags])
        params, exposure = leaf_params(state)
        rows = render_args(params, meta)
        capacity = params.xyz.shape[0]
        dev = params.xyz.device
        residuals, outs, total = [], [], torch.zeros((), device=dev)
        for view, bg, flag in zip(views, bgs, flags, strict=True):
            res = torch.zeros((capacity, 2), device=dev, requires_grad=True)
            out = rasterize(*rows, view.camera, active_sh, bg, cfg,
                            active_mask=state.active, mean2d_residual=res)
            row = exposure[view.image_index] if use_trained_exp else None
            total = total + view_loss(out["render"], out["depth"], view, row,
                                      opt, depth_w,
                                      additional_depth_maps_weight, flag)[0]
            residuals.append(res)
            outs.append(out)
        loss = total / b_total
        inputs = (*params, exposure, *residuals)
        grads = grads_or_zeros(loss, inputs)

        with torch.no_grad():
            vis = torch.stack([o["visibility"] for o in outs])
            norms = torch.stack([torch.linalg.vector_norm(g[:, :2], dim=-1)
                                 for g in grads[7:]])
            radii = torch.stack([o["radii"].detach() for o in outs])
            over = torch.stack([
                sum(o["tile_overflow"] for o in outs),
                sum(o["dup_overflow"] for o in outs)]).to(torch.float32)
            summed = all_reduce_flat(
                [*grads[:7], loss.detach().reshape(1),
                 torch.sum(vis, dim=0).to(torch.float32), over], "sum",
                group)
            g_params = GaussianParams(*summed[:6])
            g_exposure, loss_all, denom_add, over = summed[6:]
            vis_any, norm, radius = all_reduce_flat(
                [torch.any(vis, dim=0).to(torch.float32),
                 torch.amax(norms, dim=0), torch.amax(radii, dim=0)], "max",
                group)
            visible = (vis_any > 0) & state.active
            g_params = mask_grads(
                meta, g_params, torch.arange(capacity, device=dev),
                zero_scaling_grads_for_skybox)
            new_state = update(
                state, opt, g_params, g_exposure if use_trained_exp else None,
                xyz_lr, exp_lr, it)
            new_state = densify.add_stats(new_state, norm, radius, visible,
                                          denom_add)
        aux = {"loss": loss_all[0], "n_visible": torch.sum(visible),
               "tile_overflow": over[0].to(torch.int64),
               "dup_overflow": over[1].to(torch.int64)}
        return new_state, aux

    return (step_fn, lambda batch: data_shard(mesh, batch),
            lambda state: replicate_state(mesh, state))
