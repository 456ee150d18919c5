"""Adaptive density control (clone / split / prune) at a fixed capacity,
mirroring ``street_sparse_3dgs_tpu/models/densify.py``: removed rows flip
``active`` off, new rows go into free slots (lowest index first), and rows
that do not fit are counted in ``overflow`` for the host to grow the
capacity.  The split children's normal draws go in as ``noise``."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import adam
from .gaussians import (GaussianMeta, GaussianParams, activate_opacity,
                        inverse_sigmoid)
from ..core.quaternion import to_rotation_matrix
from ..device import DEFAULT_DEVICE, resolve_device


class DensifyState(NamedTuple):
    grad_accum: torch.Tensor    # [C] max screen-grad norm since last round
    denom: torch.Tensor         # [C] views the row was visible in
    max_radii2d: torch.Tensor   # [C] max pixel radius seen


def init(capacity: int,
         device: torch.device | str = DEFAULT_DEVICE) -> DensifyState:
    dev = resolve_device(device)

    def z():
        return torch.zeros((capacity,), dtype=torch.float32, device=dev)

    return DensifyState(z(), z(), z())


def add_stats(state, norm: torch.Tensor, radii: torch.Tensor,
              visible: torch.Tensor, denom_add: torch.Tensor):
    """``state`` (a ``DensifyState``, or a ``TrainState``, which has its
    fields) with the stats accumulated: ``visible`` rows take the max of
    ``norm`` (the screen-grad norm, from the grad of ``rasterize``'s
    ``mean2d_residual``) and of ``radii``; ``denom`` adds ``denom_add``
    (one view: ``visible`` as floats; a batch: each row's count of views
    it was visible in)."""
    return state._replace(
        grad_accum=torch.where(visible, torch.maximum(state.grad_accum, norm),
                               state.grad_accum),
        denom=state.denom + denom_add,
        max_radii2d=torch.where(visible,
                                torch.maximum(state.max_radii2d, radii),
                                state.max_radii2d))


class DensifyResult(NamedTuple):
    params: GaussianParams
    active: torch.Tensor
    adam_state: adam.AdamState
    densify_state: DensifyState
    n_active: torch.Tensor      # int32 scalar
    overflow: torch.Tensor      # int32 scalar: rows that did not fit


def densify_and_prune(
    noise: torch.Tensor,
    params: GaussianParams,
    active: torch.Tensor,
    adam_state: adam.AdamState,
    state: DensifyState,
    meta: GaussianMeta,
    grad_threshold: float,
    min_opacity: float,
    extent: float,
    percent_dense: float = 0.01,
    extra_prune: torch.Tensor | None = None,
) -> DensifyResult:
    """One round.  ``noise`` [2, C, 3] standard normal draws of the two
    split children (JAX: ``normal(k0)``, ``normal(k1)`` of
    ``split(key)``)."""
    capacity = params.xyz.shape[0]
    dev = params.xyz.device
    rows = torch.arange(capacity, device=dev)
    not_frozen = rows >= meta.n_frozen

    opacity = activate_opacity(params, meta)
    scales = torch.exp(params.log_scales)
    max_scale = torch.max(scales, dim=1).values

    grads = torch.nan_to_num(state.grad_accum)
    gate = (grads * state.max_radii2d
            * torch.pow(torch.clamp(opacity, min=0.0), 0.2) >= grad_threshold)
    gate = gate & (opacity > 0.15) & active & not_frozen

    prune_mask = (opacity < min_opacity) & active & not_frozen
    if extra_prune is not None:
        prune_mask = prune_mask | (extra_prune & active & not_frozen)
        gate = gate & ~extra_prune

    clone_mask = gate & (max_scale <= percent_dense * extent)
    split_mask = gate & (max_scale > percent_dense * extent)
    survive = active & ~split_mask & ~prune_mask

    # Free slots, lowest indices first (~survive rows are reusable).
    free_slots = torch.sort(survive.to(torch.int32), stable=True).indices
    n_free = capacity - torch.sum(survive)
    n_clones = torch.sum(clone_mask)
    clone_rank = torch.cumsum(clone_mask, 0) - 1
    split_rank = torch.cumsum(split_mask, 0) - 1
    n_new = n_clones + 2 * torch.sum(split_mask)
    overflow = torch.clamp(n_new - n_free, min=0).to(torch.int32)

    def slot_of(rank, want):
        """Free slot of a new row of the given rank, or ``capacity`` (the
        dropped sentinel)."""
        ok = want & (rank >= 0) & (rank < n_free)
        return torch.where(ok, free_slots[torch.clamp(rank, 0, capacity - 1)],
                           torch.full_like(rank, capacity))

    clone_slots = slot_of(clone_rank, clone_mask)
    split_slots0 = slot_of(n_clones + 2 * split_rank, split_mask)
    split_slots1 = slot_of(n_clones + 2 * split_rank + 1, split_mask)

    # Children of split rows: xyz + R (noise * scales), scales / 1.6.
    R = to_rotation_matrix(params.quats)                    # [C, 3, 3]

    def split_child(z):
        local = z * scales
        child_xyz = params.xyz + (R[:, :, 0] * local[:, None, 0]
                                  + R[:, :, 1] * local[:, None, 1]
                                  + R[:, :, 2] * local[:, None, 2])
        return params._replace(xyz=child_xyz,
                               log_scales=params.log_scales
                               - math.log(0.8 * 2))

    def scatter(dest, src, slots):
        """``dest.at[slots].set(src, mode="drop")``: slot ``capacity`` lands
        on an extra row that is cut off."""
        out = torch.cat([dest, dest[:1]])
        out[slots] = src
        return out[:capacity]

    new_params = params
    new_active = survive
    touched = torch.zeros((capacity,), dtype=torch.bool, device=dev)
    for src, slots in ((params, clone_slots),
                       (split_child(noise[0]), split_slots0),
                       (split_child(noise[1]), split_slots1)):
        new_params = GaussianParams(*(scatter(d, s, slots)
                                      for d, s in zip(new_params, src)))
        new_active = scatter(new_active, torch.ones_like(new_active), slots)
        touched = scatter(touched, torch.ones_like(touched), slots)

    return DensifyResult(params=new_params, active=new_active,
                         adam_state=adam.scatter_zero_rows(adam_state,
                                                           touched),
                         densify_state=init(capacity, dev),
                         n_active=torch.sum(new_active).to(torch.int32),
                         overflow=overflow)


def reset_opacity(params: GaussianParams, meta: GaussianMeta) -> GaussianParams:
    """Clamp opacity to <= 0.01 (activated), skybox head rows excluded."""
    op = torch.sigmoid(params.opacity_raw)
    new_raw = inverse_sigmoid(torch.clamp(op, max=0.01))
    keep_head = (torch.arange(params.opacity_raw.shape[0],
                              device=op.device) < meta.skybox_points)
    return params._replace(opacity_raw=torch.where(
        keep_head[:, None], params.opacity_raw, new_raw))
