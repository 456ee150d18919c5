"""Render a view-dependent hierarchy cut, mirroring the forward half of
``street_sparse_3dgs_tpu/hierarchy/render.py``: each selected node's
activated means/scales/SHs/opacities are lerped with its parent's by the
cut weight (the parent quaternion sign-aligned first), the skybox tail is
appended with weight 1, and the rows go through ``rasterize``.

``render_cut`` keeps every hierarchy row and gates validity with the cut
mask; ``render_cut_compact`` — the serving path of the τ-sweep eval and the
viewer — gathers only the selected rows into a power-of-two-padded buffer.
``render_cut_compacted`` is the training-side form of post-optimization:
the selected rows are compacted into a static ``capacity`` on the device
(no host sync; selected nodes beyond it are counted in ``cut_overflow``),
gathered, lerped and rasterized, and the gradients reach the full node
arrays through the gather's backward, which sums each row's slots in a
fixed order (``cuda_blend.slot_grads_to_rows``: a stable sort and a
segment sum) so that reruns are bit-identical.
"""

from __future__ import annotations

import math

import torch

from ..core.camera import CameraParams
from ..core.quaternion import align_sign
from ..models.gaussians import GaussianParams, sh_coeffs
from ..ops.cuda_blend import slot_grads_to_rows
from ..ops.rasterize import RasterConfig, rasterize
from .structure import Cut


def blend_cut(params: GaussianParams, cut: Cut, n_nodes: int,
              skybox_count: int):
    """Lerp every tree row toward its parent by its cut weight.  Returns
    activated (means, scales, quats, opacities, shs, active_mask) over
    [n_nodes + skybox_count] rows (abs-opacity hierarchy convention)."""
    total = params.xyz.shape[0]
    dev = params.xyz.device
    pad = total - n_nodes
    w = torch.cat([cut.weights,
                   torch.ones(pad, dtype=cut.weights.dtype, device=dev)])
    w = w[:, None]
    par = torch.cat([cut.parent.to(torch.int64),
                     torch.arange(n_nodes, total, device=dev)])

    xyz = params.xyz
    scales = torch.exp(params.log_scales)
    opac = torch.abs(params.opacity_raw[:, 0])
    sh = sh_coeffs(params)
    quats = params.quats

    xyz_b = w * xyz + (1.0 - w) * xyz[par]
    scales_b = w * scales + (1.0 - w) * scales[par]
    opac_b = w[:, 0] * opac + (1.0 - w[:, 0]) * opac[par]
    sh_b = w[:, :, None] * sh + (1.0 - w[:, :, None]) * sh[par]
    parents_q = align_sign(quats[par], quats)
    quats_b = w * quats + (1.0 - w) * parents_q

    active = torch.cat([cut.selected,
                        torch.ones(pad, dtype=torch.bool, device=dev)])
    return xyz_b, scales_b, quats_b, opac_b, sh_b, active


def render_cut(h_params: GaussianParams, cut: Cut, n_nodes: int,
               skybox_count: int, camera: CameraParams, sh_degree: int,
               bg: torch.Tensor, config: RasterConfig = RasterConfig(),
               mean2d_residual: torch.Tensor | None = None):
    """Render of a hierarchy cut over all rows, mask-gated."""
    xyz, scales, quats, opac, sh, active = blend_cut(
        h_params, cut, n_nodes, skybox_count)
    return rasterize(xyz, scales, quats, opac, sh, camera, sh_degree, bg,
                     config, active_mask=active,
                     mean2d_residual=mean2d_residual)


def compact_cut_indices(cut: Cut, capacity: int):
    """Compaction of a cut's selected set into a static ``capacity``-slot
    index buffer, in ascending node order, on the cut's device with no host
    sync (``torch.nonzero`` has no size argument and syncs on CUDA): each
    selected node's position is a running count, and the node ids are
    scattered to those positions.

    Returns ``(gi, gp, w, valid, overflow)``: gathered node index, parent
    index and lerp weight per slot, the slot-validity mask, and the count of
    selected nodes that did NOT fit, ``max(count - capacity, 0)`` — never
    silently dropped: the post-opt driver grows the capacity and redoes the
    step.  Padding slots hold node 0 with weight 1."""
    sel = cut.selected
    dev = sel.device
    n = sel.shape[0]
    pos = torch.cumsum(sel.to(torch.int64), 0) - 1
    count = pos[-1] + 1 if n else torch.zeros((), dtype=torch.int64,
                                              device=dev)
    # Nodes that are not selected or do not fit go to a dump slot.
    target = torch.where(sel & (pos < capacity), pos,
                         torch.full_like(pos, capacity))
    idx = torch.zeros(capacity + 1, dtype=torch.int64, device=dev)
    idx.scatter_(0, target, torch.arange(n, device=dev))
    valid = torch.arange(capacity, device=dev) < torch.clamp(count,
                                                             max=capacity)
    gi = torch.where(valid, idx[:capacity], torch.zeros_like(idx[:capacity]))
    gp = cut.parent[gi]
    w = torch.where(valid, cut.weights[gi], torch.ones_like(cut.weights[gi]))
    overflow = torch.clamp(count - capacity, min=0)
    return gi.to(torch.int32), gp, w, valid, overflow


class _GatherRows(torch.autograd.Function):
    """``x[ids]`` for x [M, C] whose backward sums each row's slots in a
    fixed order (``slot_grads_to_rows``), where the autograd backward of an
    index is an atomic scatter-add on CUDA.  Slots where ``live`` is False
    (padding, whose cotangent is zero) are left out of the backward: as
    many padding slots as the capacity has spare would otherwise make one
    long segment of row 0, which the segment sum walks serially."""

    @staticmethod
    def forward(ctx, x, ids, live):
        m = x.shape[0]
        ctx.save_for_backward(torch.where(live, ids, torch.full_like(ids, m)))
        ctx.m = m
        return x[ids]

    @staticmethod
    def backward(ctx, d):
        (ids,) = ctx.saved_tensors
        return slot_grads_to_rows(d, ids, ctx.m), None, None


def blend_cut_compact(params: GaussianParams, cut: Cut, n_nodes: int,
                      skybox_count: int, capacity: int):
    """O(cut) differentiable analogue of ``blend_cut``: gather ONLY the
    selected rows (+ the skybox tail) into ``capacity + skybox`` slots and
    lerp there.  The raw parameter rows are packed [rows, 11 + 3K] (59 at
    SH degree 3) and gathered once for the nodes and their parents, so one
    deterministic reduction carries every gradient back to the full node
    arrays.

    Returns (means, scales, quats, opacities, shs, active, overflow)."""
    total = params.xyz.shape[0]
    dev = params.xyz.device
    gi, gp, w, valid, overflow = compact_cut_indices(cut, capacity)
    sky = torch.arange(n_nodes, total, device=dev)
    gi = torch.cat([gi.to(torch.int64), sky])
    gp = torch.cat([gp.to(torch.int64), sky])
    w = torch.cat([w, torch.ones(total - n_nodes, dtype=w.dtype,
                                 device=dev)])[:, None]
    active = torch.cat([valid, torch.ones(total - n_nodes, dtype=torch.bool,
                                          device=dev)])

    # Gather RAW rows, activate on the compact buffer: every elementwise
    # activation is O(cut), not O(nodes).
    k = params.features_rest.shape[1] + 1
    packed = torch.cat([params.xyz, params.log_scales, params.quats,
                        params.opacity_raw,
                        params.features_dc.reshape(total, -1),
                        params.features_rest.reshape(total, -1)], dim=1)
    rows = _GatherRows.apply(packed, torch.cat([gi, gp]),
                             torch.cat([active, active]))
    ri, rp = rows[:gi.shape[0]], rows[gi.shape[0]:]

    def fields(r):
        return (r[:, 0:3], torch.exp(r[:, 3:6]), r[:, 6:10],
                torch.abs(r[:, 10]), r[:, 11:].reshape(-1, k, 3))

    xyz_i, scales_i, quats_i, opac_i, sh_i = fields(ri)
    xyz_p, scales_p, quats_p, opac_p, sh_p = fields(rp)

    # Padding slots gather row 0; zero them so that their cotangents cannot
    # leak into row 0 through the gather's backward.
    def z(x):
        return torch.where(active.reshape((-1,) + (1,) * (x.dim() - 1)), x,
                           torch.zeros_like(x))

    xyz_b = z(w * xyz_i + (1.0 - w) * xyz_p)
    scales_b = z(w * scales_i + (1.0 - w) * scales_p)
    opac_b = z(w[:, 0] * opac_i + (1.0 - w[:, 0]) * opac_p)
    sh_b = z(w[:, :, None] * sh_i + (1.0 - w[:, :, None]) * sh_p)
    parents_q = align_sign(quats_p, quats_i)
    quats_b = z(w * quats_i + (1.0 - w) * parents_q)
    # Zeroed quats are degenerate for the rotation math downstream; park the
    # padding slots at identity (a constant: no cotangent).
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=quats_i.dtype,
                         device=dev)
    quats_b = torch.where(active[:, None], quats_b, ident)
    return xyz_b, scales_b, quats_b, opac_b, sh_b, active, overflow


def render_cut_compacted(h_params: GaussianParams, cut: Cut, n_nodes: int,
                         skybox_count: int, capacity: int,
                         camera: CameraParams, sh_degree: int,
                         bg: torch.Tensor,
                         config: RasterConfig = RasterConfig()):
    """Differentiable render over the compacted cut: rasterization cost is
    O(capacity + skybox), not O(nodes).  Adds ``cut_overflow`` to the raster
    outputs (selected nodes beyond capacity — the caller must grow and
    retry)."""
    xyz, scales, quats, opac, sh, active, overflow = blend_cut_compact(
        h_params, cut, n_nodes, skybox_count, capacity)
    out = rasterize(xyz, scales, quats, opac, sh, camera, sh_degree, bg,
                    config, active_mask=active)
    out["cut_overflow"] = overflow
    return out


def compact_cut_params(h_params: GaussianParams, cut: Cut, n_nodes: int,
                       skybox_count: int, pad_to_pow2: bool = True):
    """Gather only the selected nodes (+ skybox tail), blend them with their
    parents and return dense activated arrays.  The row count is padded to
    a power of two (at least 16), like the JAX function, so repeated calls
    see a bounded set of shapes; padding rows are inactive."""
    dev = h_params.xyz.device
    sel = torch.nonzero(cut.selected).reshape(-1)
    total = h_params.xyz.shape[0]
    sky = torch.arange(n_nodes, total, device=dev)
    idx = torch.cat([sel, sky])
    par = torch.cat([cut.parent[sel].to(torch.int64), sky])
    w = torch.cat([cut.weights[sel],
                   torch.ones(sky.shape[0], dtype=torch.float32, device=dev)])

    n = idx.shape[0]
    n_pad = (1 << max(4, math.ceil(math.log2(max(n, 1))))
             if pad_to_pow2 else n)
    pad = n_pad - n
    zpad = torch.zeros(pad, dtype=torch.int64, device=dev)
    gi = torch.cat([idx, zpad])
    gp = torch.cat([par, zpad])
    wj = torch.cat([w, torch.ones(pad, dtype=torch.float32,
                                  device=dev)])[:, None]
    active = torch.arange(n_pad, device=dev) < n

    xyz = h_params.xyz
    scales = torch.exp(h_params.log_scales)
    opac = torch.abs(h_params.opacity_raw[:, 0])
    sh = sh_coeffs(h_params)
    quats = h_params.quats

    xyz_b = wj * xyz[gi] + (1 - wj) * xyz[gp]
    scales_b = wj * scales[gi] + (1 - wj) * scales[gp]
    opac_b = wj[:, 0] * opac[gi] + (1 - wj[:, 0]) * opac[gp]
    sh_b = wj[:, :, None] * sh[gi] + (1 - wj[:, :, None]) * sh[gp]
    parents_q = align_sign(quats[gp], quats[gi])
    quats_b = wj * quats[gi] + (1 - wj) * parents_q
    return xyz_b, scales_b, quats_b, opac_b, sh_b, active


def render_cut_compact(h_params: GaussianParams, cut: Cut, n_nodes: int,
                       skybox_count: int, camera: CameraParams,
                       sh_degree: int, bg: torch.Tensor,
                       config: RasterConfig = RasterConfig(),
                       scale_modifier: float = 1.0):
    """Serving-path render over the compacted cut (forward only)."""
    xyz, scales, quats, opac, sh, active = compact_cut_params(
        h_params, cut, n_nodes, skybox_count)
    return rasterize(xyz, scales, quats, opac, sh, camera, sh_degree, bg,
                     config, scale_modifier=scale_modifier,
                     active_mask=active)
