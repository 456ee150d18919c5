"""Ring-staged rendering and training: the Gaussians AND the tiles sharded
over the ranks of one mesh axis, mirroring ``street_sparse_3dgs_tpu/
parallel/ring.py``.  For a chunk whose rows exceed one device's memory: no
rank ever holds every row.

The execution model: a rank is a process with one explicit
``torch.device`` (``parallel/mesh.py``); the collectives go through
``parallel/collectives.py``.  Rank r owns rows [r · blk, (r + 1) · blk)
and the tile slab [r · t_local, (r + 1) · t_local), and projects its own
rows.  In n stages every block visits every rank along the ring
(``ring_shift``, every rank running the same number of stages):

- Pass A (no gradient) circulates the geometry (mean2d, radius, depth,
  validity) and banks the (tile, depth, row) triples of the visiting
  block that land in this rank's slab, at most ``stage_pair_capacity`` a
  stage (overflow counted, ``ring.py:122-190``).  The banked pairs sorted
  by (tile, depth, row) are the serial blend order; cut into per-tile
  tables of global rows.
- Pass B circulates the packed attribute rows [blk, 10]; each stage copies
  the rows its table references.  Their grads go back to the owner through
  the reverse shift (``ring.py:193-205``).

Then K1 blends the slab at its ``tile0`` (``ring.py:210``) and
``all_gather_slabs`` assembles the image on every rank.  Pass A expands a
row's covered tile rectangle, capped at ``max_dup`` tiles, with no
ellipse culling (as JAX's ring does), so its tables hold the serial
binning's pairs plus pairs whose alpha stays under 1/255 over their tile:
without overflow the images agree.  Exact mode is refused, as in JAX.
"""

from __future__ import annotations

import torch

from ..config import OptimizationConfig, PipelineConfig
from ..core.camera import CameraParams
from ..models import densify
from ..models.gaussians import GaussianMeta, GaussianParams
from ..ops.binning import num_tiles, tile_rect
from ..ops import cuda_blend
from ..ops.cuda_blend import N_CH, image_outputs
from ..ops.preprocess import project_gaussians
from ..ops.rasterize import RasterConfig
from ..train import losses
from ..train.step import (CameraBatch, TrainState, grads_or_zeros,
                          leaf_params, mask_grads, raster_config,
                          render_args, schedules, update, view_loss)
from .collectives import (all_gather_slabs, all_reduce, ring_shift,
                          sum_grads)
from .mesh import Mesh


def rect_pairs(mean2d: torch.Tensor, radius: torch.Tensor,
               valid: torch.Tensor, tiles_x: int, tiles_y: int,
               max_dup: int):
    """Each row's first ``max_dup`` tiles of its covered rectangle, row
    major: (tile ids [n, max_dup] int64, in range [n, max_dup] bool, the
    tiles past the cap summed)."""
    x0, y0, x1, y1 = tile_rect(mean2d, radius, tiles_x, tiles_y)
    zero = torch.zeros_like(x0)
    nx = torch.where(valid, x1 - x0, zero).to(torch.int64)
    ny = torch.where(valid, y1 - y0, zero).to(torch.int64)
    cov = nx * ny
    slots = torch.arange(max_dup, device=mean2d.device)
    nxs = torch.clamp(nx, min=1)
    sy = torch.div(slots[None, :], nxs[:, None], rounding_mode="floor")
    sx = slots[None, :] - sy * nxs[:, None]
    tile = (y0.to(torch.int64)[:, None] + sy) * tiles_x \
        + (x0.to(torch.int64)[:, None] + sx)
    in_range = slots[None, :] < torch.clamp(cov, max=max_dup)[:, None]
    return tile, in_range, torch.sum(torch.clamp(cov - max_dup, min=0))


def rasterize_ring_staged(
    means3d: torch.Tensor,          # [blk, 3] this rank's rows
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    sh_coeffs: torch.Tensor,
    camera: CameraParams,
    sh_degree: int,
    bg: torch.Tensor,
    mesh: Mesh,
    config: RasterConfig = RasterConfig(method="pallas"),
    active_mask: torch.Tensor | None = None,
    stage_pair_capacity: int | None = None,
    axis: str = "tile",
    mean2d_residual: torch.Tensor | None = None,
):
    """Differentiable render with this rank's block of rows (every rank
    the same block size ``blk``; pad with inactive rows).
    ``stage_pair_capacity`` bounds the pairs banked from one visiting block
    (default the lossless blk · max_dup).  Returns the dict of
    ``ops.rasterize.rasterize`` (the image replicated on every rank;
    ``radii`` and ``visibility`` of this rank's rows) plus
    ``pair_overflow``; the counters are summed over the ranks (the dup
    count, which every rank sees for every block, divided by the
    ranks)."""
    if config.exact_extra:
        raise ValueError(
            "rasterize_ring_staged does not support exact_extra; raise "
            "tile_capacity (per-rank tiles are 1/n of the image) or use "
            "the tile-sharded exact path for models that fit one device")
    group = mesh.group(axis)
    n, r = mesh.size(axis), mesh.index(axis)
    blk = means3d.shape[0]
    h, w = camera.height, camera.width
    tiles_x, tiles_y = num_tiles(h, w)
    t_pad = -(-tiles_x * tiles_y // n) * n
    t_local = t_pad // n
    t0 = r * t_local
    max_dup, k_cap = config.max_dup, config.tile_capacity
    p_stage = stage_pair_capacity or blk * max_dup
    (bg,) = sum_grads(group, bg)
    proj = project_gaussians(means3d, scales, quats, opacities, sh_coeffs,
                             camera, sh_degree, 1.0, active_mask)
    if mean2d_residual is not None:
        proj = proj._replace(mean2d=proj.mean2d + mean2d_residual)
    dev = means3d.device

    # ---- Pass A: circulate the geometry, bank this slab's pairs ----------
    with torch.no_grad():
        geo = torch.stack([proj.mean2d[:, 0], proj.mean2d[:, 1], proj.radius,
                           proj.depth, proj.valid.to(torch.float32)],
                          dim=1).contiguous()
        b_tile, b_dep, b_row = [], [], []
        dup_ovf = pair_ovf = torch.zeros((), dtype=torch.int64, device=dev)
        for s in range(n):
            vbase = ((r - s) % n) * blk
            tile, in_range, d_ovf = rect_pairs(
                geo[:, :2], geo[:, 2], geo[:, 4] > 0, tiles_x, tiles_y,
                max_dup)
            loc = (tile - t0).reshape(-1)
            mine = in_range.reshape(-1) & (loc >= 0) & (loc < t_local)
            # Kept pairs first, in (row, slot) order, cut at the capacity.
            keep = torch.sort((~mine).to(torch.int8),
                              stable=True).indices[:p_stage]
            ok = mine[keep]
            row = torch.div(keep, max_dup, rounding_mode="floor")
            b_tile.append(torch.where(ok, loc[keep],
                                      torch.full_like(keep, t_local)))
            b_dep.append(torch.where(ok, geo[row, 3],
                                     torch.full_like(geo[row, 3], torch.inf)))
            b_row.append(vbase + row)
            dup_ovf = dup_ovf + d_ovf
            pair_ovf = pair_ovf + torch.clamp(torch.sum(mine) - p_stage,
                                              min=0)
            if s < n - 1:
                geo = ring_shift(geo, group)
        p_tile, p_dep, p_row = (torch.cat(x) for x in (b_tile, b_dep, b_row))
        # (tile, depth, row), the serial blend order: stable sorts, the
        # least significant key first.
        idx = torch.sort(p_row, stable=True).indices
        idx = idx[torch.sort(p_dep[idx], stable=True).indices]
        idx = idx[torch.sort(p_tile[idx], stable=True).indices]
        s_tile, s_row = p_tile[idx], p_row[idx]
        bounds = torch.searchsorted(
            s_tile, torch.arange(t_local + 1, device=dev))
        starts, counts = bounds[:-1], bounds[1:] - bounds[:-1]
        tile_ovf = torch.sum(torch.clamp(counts - k_cap, min=0))
        kk = torch.arange(k_cap, device=dev)
        tmask = kk[None, :] < torch.clamp(counts, max=k_cap)[:, None]
        slot = torch.clamp(starts[:, None] + kk[None, :],
                           max=s_row.shape[0] - 1)
        table = torch.where(tmask, s_row[slot], torch.full_like(slot, -1))

    # ---- Pass B: circulate the packed attributes, fill the tables --------
    attrs_v = torch.cat([proj.mean2d, proj.conic, proj.color,
                         proj.opacity[:, None], proj.inv_depth[:, None]],
                        dim=1).to(torch.float32)            # [blk, 10]
    flat_table = table.reshape(-1)
    picked, where_to = [], []
    for s in range(n):
        vbase = ((r - s) % n) * blk
        local = flat_table - vbase
        sel = torch.nonzero((local >= 0) & (local < blk)).reshape(-1)
        picked.append(attrs_v[local[sel]])
        where_to.append(sel)
        if s < n - 1:
            attrs_v = ring_shift(attrs_v, group)
    slots = torch.zeros((t_local * k_cap, N_CH), dtype=torch.float32,
                        device=dev)
    slots = slots.index_put((torch.cat(where_to),), torch.cat(picked))
    attrs_t = slots.reshape(t_local, k_cap, N_CH).transpose(1, 2) \
        .contiguous()                                       # [t_l, 10, K]
    out = cuda_blend.blend_padded(
        attrs_t, counts.to(torch.int32).contiguous(),
        bg.reshape(1, 3).to(torch.float32).contiguous(), tiles_x, tile0=t0)
    full = all_gather_slabs(out, group)
    dup_all, pair_all, tile_all = all_reduce(
        torch.stack([dup_ovf, pair_ovf, tile_ovf]), "sum", group)
    res = image_outputs(full, tiles_x, tiles_y, h, w)
    res.update(radii=proj.radius.detach(), visibility=proj.valid,
               dup_overflow=dup_all // n, pair_overflow=pair_all,
               tile_overflow=tile_all)
    return res


def make_ring_train_step(
    meta: GaussianMeta,
    opt: OptimizationConfig,
    pipe: PipelineConfig,
    spatial_lr_scale: float,
    mesh: Mesh,
    axis: str = "tile",
    *,
    use_trained_exp: bool = True,
    optimize_xyz: bool = True,
    zero_scaling_grads_for_skybox: bool = False,
    additional_depth_maps_weight: float = 0.9,
    stage_pair_capacity: int | None = None,
):
    """Model-parallel training step: the rows of the parameters, Adam
    moments and densify statistics sharded over ``mesh[axis]``, one view a
    step rendered by the ring.  Returns ``(step_fn, shard_state)``:
    ``shard_state(state)`` slices this rank's rows out of a whole
    ``TrainState`` (exposure and step counters whole), and ``step_fn(
    state, view, bg, active_sh=None, depth_flag=False) -> (state, aux)``
    steps the rank's rows.  The loss and the exposure update are
    replicated (the image is); ``aux["n_visible"]`` is summed over the
    ranks."""
    cfg = raster_config(pipe)
    group = mesh.group(axis)
    n, r = mesh.size(axis), mesh.index(axis)
    losses.tf32_off()

    def step_fn(state: TrainState, view: CameraBatch, bg: torch.Tensor,
                active_sh: int | None = None, depth_flag: bool = False):
        active_sh = meta.sh_degree if active_sh is None else active_sh
        it = int(state.step) + 1
        xyz_lr, exp_lr, depth_w = schedules(opt, it, spatial_lr_scale,
                                            optimize_xyz)
        params, exposure = leaf_params(state)
        blk = params.xyz.shape[0]
        dev = params.xyz.device
        res = torch.zeros((blk, 2), device=dev, requires_grad=True)
        out = rasterize_ring_staged(
            *render_args(params, meta), view.camera, active_sh, bg, mesh,
            cfg, active_mask=state.active,
            stage_pair_capacity=stage_pair_capacity, axis=axis,
            mean2d_residual=res)
        row = exposure[view.image_index] if use_trained_exp else None
        loss, _ = view_loss(out["render"], out["depth"], view, row, opt,
                            depth_w, additional_depth_maps_weight,
                            bool(depth_flag))
        inputs = (*params, exposure, res)
        grads = grads_or_zeros(loss, inputs)
        with torch.no_grad():
            visible = out["visibility"] & state.active
            g_params = mask_grads(
                meta, GaussianParams(*grads[:6]),
                r * blk + torch.arange(blk, device=dev),
                zero_scaling_grads_for_skybox)
            new_state = update(
                state, opt, g_params, grads[6] if use_trained_exp else None,
                xyz_lr, exp_lr, it)
            norm = torch.linalg.vector_norm(grads[7][:, :2], dim=-1)
            new_state = densify.add_stats(new_state, norm, out["radii"],
                                          visible, visible.to(torch.float32))
            aux = {"loss": loss.detach(),
                   "n_visible": all_reduce(torch.sum(visible), "sum", group),
                   "tile_overflow": out["tile_overflow"],
                   "dup_overflow": out["dup_overflow"],
                   "pair_overflow": out["pair_overflow"]}
        return new_state, aux

    def shard_state(state: TrainState) -> TrainState:
        capacity = state.params.xyz.shape[0]
        if capacity % n:
            raise ValueError(f"capacity {capacity} does not split over "
                             f"{n} ranks")
        blk = capacity // n

        def rows(x):
            return x[r * blk:(r + 1) * blk]

        return TrainState(
            params=GaussianParams(*(rows(p) for p in state.params)),
            active=rows(state.active),
            adam_state=state.adam_state._replace(
                mu=GaussianParams(*(rows(p) for p in state.adam_state.mu)),
                nu=GaussianParams(*(rows(p) for p in state.adam_state.nu))),
            exposure=state.exposure, exposure_adam=state.exposure_adam,
            grad_accum=rows(state.grad_accum), denom=rows(state.denom),
            max_radii2d=rows(state.max_radii2d), step=state.step)

    return step_fn, shard_state
