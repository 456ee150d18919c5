"""Render a view-dependent hierarchy cut, mirroring the forward half of
``street_sparse_3dgs_tpu/hierarchy/render.py``: each selected node's
activated means/scales/SHs/opacities are lerped with its parent's by the
cut weight (the parent quaternion sign-aligned first), the skybox tail is
appended with weight 1, and the rows go through ``rasterize``.

``render_cut`` keeps every hierarchy row and gates validity with the cut
mask; ``render_cut_compact`` — the serving path of the τ-sweep eval and the
viewer — gathers only the selected rows into a power-of-two-padded buffer.
The training-side compacted gather waits for the training slice.
"""

from __future__ import annotations

import math

import torch

from ..core.camera import CameraParams
from ..core.quaternion import align_sign
from ..models.gaussians import GaussianParams, sh_coeffs
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
