"""Tile-sharded training: the blend of a whole batch split over the
(data x tile) ranks, mirroring ``street_sparse_3dgs_tpu/parallel/tp.py``.

The execution model: a rank is a process with one explicit
``torch.device`` (``parallel/mesh.py``); the collectives go through
``parallel/collectives.py``.  Every rank projects and bins all B views
(replicated, as in JAX).  The views' tile ranges, each padded to a
multiple of the ranks, are concatenated into one axis of B · T_pad tiles,
and rank r (combined index data · n_tile + tile) blends the contiguous
slab [r · t_local, (r + 1) · t_local):

- padded: K1 with ``t_mod = T_pad`` (a tile's pixel origin wraps per view),
  its ``tile0`` and a per-tile background [t_local, 3] (``tp.py:108-135``);
- exact (``_rasterize_batch_exact``, ``tp.py:160-253``): per-view
  shard-segmented bins, global tile ids ``view · tpp + local`` (the index
  in the concatenated ``last_v``, which keeps the last window of every
  padded tile in range), K3 with ``t_mod = tpp`` over the rank's tiles
  (``order``) on a zero background; the per-view background is composited
  outside as ``rgb + (1 - alpha) · bg``.

``all_gather_slabs`` assembles every view's rows on every rank; the rows,
backgrounds and screen residuals below it get their partial grads summed
over all the ranks (``sum_grads``).  ``make_tile_sharded_train_step`` has
the data-parallel step's semantics (batch-mean loss, union visibility,
per-row max densify stats, depth-only views) with the parameters, the
exposure and the update replicated; in exact counts mode the update is
guarded on ``tile_overflow == 0`` (``update_skipped``).  Random draws are
inputs: the step takes the [B, 3] backgrounds.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..config import OptimizationConfig, PipelineConfig
from ..core.camera import CameraParams
from ..models import densify
from ..models.gaussians import GaussianMeta, GaussianParams
from ..ops.binning import bin_gaussians, num_tiles
from ..ops import cuda_blend
from ..ops.preprocess import project_gaussians
from ..ops.cuda_blend import image_outputs
from ..ops.rasterize import RasterConfig, attr_dtype, bin_kwargs
from ..train import losses
from ..train.step import (CameraBatch, TrainState, grads_or_zeros,
                          leaf_params, mask_grads, raster_config,
                          render_args, revert_on_overflow, schedules,
                          update, view_loss)
from .collectives import all_gather_slabs, sum_grads
from .mesh import Mesh, replicate_state
from .tiles import pad_tiles, padded_last_v


def rasterize_batch_tile_sharded(
    means3d, scales, quats, opacities, shs,
    cameras: Sequence[CameraParams],
    sh_degree: int,
    bgs: torch.Tensor,                    # [B, 3] per-view backgrounds
    mesh: Mesh,
    axes: tuple[str, ...] = ("data", "tile"),
    config: RasterConfig | None = None,
    active_mask: torch.Tensor | None = None,
    mean2d_residual: torch.Tensor | None = None,   # [B, N, 2]
):
    """Render B views (one resolution) with all their tiles split over the
    ranks of ``axes``; every rank passes the same rows and gets every view.
    Returns render [B,3,H,W], depth [B,1,H,W], alpha [B,H,W], radii and
    visibility [B,N], the overflow counters summed over the views.  The
    grads of the rows, ``bgs`` and ``mean2d_residual`` are summed over the
    ranks in the backward."""
    cfg = config or RasterConfig(method="pallas")
    group = mesh.group(axes)
    n, r = mesh.size(axes), mesh.index(axes)
    (means3d, scales, quats, opacities, shs, bgs,
     mean2d_residual) = sum_grads(group, means3d, scales, quats, opacities,
                                  shs, bgs, mean2d_residual)
    b = bgs.shape[0]
    h, w = cameras[0].height, cameras[0].width
    projs = []
    for i, cam in enumerate(cameras):
        proj = project_gaussians(means3d, scales, quats, opacities, shs, cam,
                                 sh_degree, 1.0, active_mask)
        if mean2d_residual is not None:
            proj = proj._replace(mean2d=proj.mean2d + mean2d_residual[i])
        projs.append(proj)
    if cfg.exact_extra:
        flat, tpp, bins_list = _blend_exact_batch(projs, h, w, bgs, group,
                                                  n, r, cfg)
    else:
        flat, tpp, bins_list = _blend_padded_batch(projs, h, w, bgs, group,
                                                   n, r, cfg)
    tiles_x, tiles_y = num_tiles(h, w)
    views = [image_outputs(flat[i * tpp:(i + 1) * tpp], tiles_x, tiles_y, h,
                           w) for i in range(b)]
    out = {k: torch.stack([v[k] for v in views])
           for k in ("render", "depth", "alpha")}
    if cfg.exact_extra:
        out["render"] = out["render"] + (1.0 - out["alpha"])[:, None] \
            * bgs[:, :, None, None]
    out.update(radii=torch.stack([p.radius for p in projs]),
               visibility=torch.stack([p.valid for p in projs]),
               dup_overflow=sum(bn.dup_overflow for bn in bins_list),
               tile_overflow=sum(bn.tile_overflow for bn in bins_list))
    return out


def _blend_padded_batch(projs, h, w, bgs, group, n, r, cfg):
    """K1 over this rank's slab of the B · T_pad concatenated tiles; each
    view packs only the rows of its tiles that fall in the slab.  Returns
    (rows [B · T_pad, 8, 256] of every rank, T_pad, bins)."""
    b = len(projs)
    tiles_x, tiles_y = num_tiles(h, w)
    t_pad = -(-tiles_x * tiles_y // n) * n
    t_local = b * t_pad // n
    lo, hi = r * t_local, (r + 1) * t_local
    attrs, counts, bins_list = [], [], []
    for i, proj in enumerate(projs):
        bins = bin_gaussians(proj, h, w, cfg.max_dup, cfg.tile_capacity,
                             **bin_kwargs(cfg))
        bins_list.append(bins)
        a, e = max(lo - i * t_pad, 0), min(hi - i * t_pad, t_pad)
        if a >= e:
            continue
        gather = pad_tiles(bins.gather, t_pad, bins.order.shape[0])[a:e]
        attrs.append(cuda_blend.pack_gather_attrs(
            gather, proj.mean2d, proj.conic, proj.color, proj.opacity,
            proj.inv_depth, dtype=attr_dtype(cfg), order=bins.order,
            rank=bins.rank, grad_sort=cfg.grad_sort))
        counts.append(pad_tiles(bins.counts.to(torch.int32), t_pad)[a:e])
    bg_tiles = torch.repeat_interleave(bgs.to(torch.float32), t_pad,
                                       dim=0)[lo:hi].contiguous()
    out = cuda_blend.blend_padded(torch.cat(attrs),
                                  torch.cat(counts).contiguous(), bg_tiles,
                                  tiles_x, tile0=lo, t_mod=t_pad)
    return all_gather_slabs(out, group), t_pad, bins_list


def _blend_exact_batch(projs, h, w, bgs, group, n, r, cfg):
    """K3 over this rank's real tiles of the concatenated per-view window
    layouts (global tile ids ``view · tpp + local``, ``t_mod = tpp``) on a
    zero background.  Returns (rows [B · tpp, 8, 256] of every rank, tpp,
    bins)."""
    b = len(projs)
    tiles_x, _ = num_tiles(h, w)
    extra = -(-cfg.exact_extra // n) * n
    attrs, vcounts, wt, last_v, bins_list = [], [], [], [], []
    t_v = tpp = None
    for i, proj in enumerate(projs):
        bins = bin_gaussians(proj, h, w, cfg.max_dup, cfg.tile_capacity,
                             **bin_kwargs(cfg, extra, n))
        bins_list.append(bins)
        attrs.append(cuda_blend.pack_gather_attrs(
            bins.gather, proj.mean2d, proj.conic, proj.color, proj.opacity,
            proj.inv_depth, dtype=attr_dtype(cfg), order=bins.order,
            rank=bins.rank, grad_sort=cfg.grad_sort, seg_pos=bins.seg_pos,
            pair_major=True))
        t_v = bins.t_of_v.shape[0]
        tpp = t_v - extra                 # the shard-padded tile count
        vcounts.append(bins.vcounts)
        wt.append(bins.wt)
        last_v.append(padded_last_v(bins, tpp) + i * t_v)
    t_local = b * tpp // n
    lo, hi = r * t_local, (r + 1) * t_local
    dev = attrs[0].device
    zero_bg = torch.zeros((1, 3), dtype=torch.float32, device=dev)
    order = torch.arange(lo, hi, dtype=torch.int32, device=dev)
    out = cuda_blend.blend_exact(torch.cat(attrs), torch.cat(vcounts),
                                 torch.cat(wt), torch.cat(last_v), zero_bg,
                                 tiles_x, t_mod=tpp, order=order)[lo:hi]
    return all_gather_slabs(out, group), tpp, bins_list


def make_tile_sharded_train_step(
    meta: GaussianMeta,
    opt: OptimizationConfig,
    pipe: PipelineConfig,
    spatial_lr_scale: float,
    mesh: Mesh,
    axes: tuple[str, ...] = ("data", "tile"),
    *,
    use_trained_exp: bool = True,
    optimize_xyz: bool = True,
    zero_scaling_grads_for_skybox: bool = False,
    additional_depth_maps_weight: float = 0.9,
):
    """Returns ``(step_fn, replicate_all)``.  ``step_fn(state, views, bgs,
    active_sh=None, depth_flags=None) -> (state, aux)`` takes the WHOLE
    batch on every rank (a list of B ``CameraBatch``, their [B, 3]
    backgrounds and B depth-only flags).  ``aux``: the batch-mean loss,
    ``n_visible``, the overflow counters and, in exact counts mode,
    ``update_skipped``.  ``replicate_all`` broadcasts a state from rank
    0."""
    cfg = raster_config(pipe)
    losses.tf32_off()

    def step_fn(state: TrainState, views: Sequence[CameraBatch],
                bgs: torch.Tensor, active_sh: int | None = None,
                depth_flags: Sequence[bool] | None = None):
        active_sh = meta.sh_degree if active_sh is None else active_sh
        it = int(state.step) + 1
        xyz_lr, exp_lr, depth_w = schedules(opt, it, spatial_lr_scale,
                                            optimize_xyz)
        b = len(views)
        flags = ([False] * b if depth_flags is None
                 else [bool(f) for f in depth_flags])
        params, exposure = leaf_params(state)
        capacity = params.xyz.shape[0]
        dev = params.xyz.device
        res = torch.zeros((b, capacity, 2), device=dev, requires_grad=True)
        out = rasterize_batch_tile_sharded(
            *render_args(params, meta), [v.camera for v in views], active_sh,
            bgs, mesh, axes, cfg, active_mask=state.active,
            mean2d_residual=res)
        total = torch.zeros((), device=dev)
        for i, view in enumerate(views):
            row = exposure[view.image_index] if use_trained_exp else None
            total = total + view_loss(out["render"][i], out["depth"][i],
                                      view, row, opt, depth_w,
                                      additional_depth_maps_weight,
                                      flags[i])[0]
        loss = total / b
        inputs = (*params, exposure, res)
        grads = grads_or_zeros(loss, inputs)

        with torch.no_grad():
            vis = out["visibility"]
            visible = torch.any(vis, dim=0) & state.active
            norm = torch.amax(torch.linalg.vector_norm(grads[7][..., :2],
                                                       dim=-1), dim=0)
            g_params = mask_grads(meta, GaussianParams(*grads[:6]),
                                  torch.arange(capacity, device=dev),
                                  zero_scaling_grads_for_skybox)
            new_state = update(
                state, opt, g_params, grads[6] if use_trained_exp else None,
                xyz_lr, exp_lr, it)
            new_state = densify.add_stats(
                new_state, norm, torch.amax(out["radii"].detach(), dim=0),
                visible, torch.sum(vis, dim=0).to(torch.float32))
            aux = {"loss": loss.detach(), "n_visible": torch.sum(visible),
                   "tile_overflow": out["tile_overflow"],
                   "dup_overflow": out["dup_overflow"]}
            new_state = revert_on_overflow(cfg, out["tile_overflow"], state,
                                           new_state, aux)
        return new_state, aux

    return step_fn, lambda state: replicate_state(mesh, state)
