"""Per-Gaussian screen-space preprocessing, mirroring
``street_sparse_3dgs_tpu/ops/preprocess.py``: world->camera transform,
frustum cull, projection, EWA covariance, conic, pixel radius, SH->RGB.

All outputs are [N, ...] with a validity mask; culled rows get radius 0,
depth +inf, inverse depth 0 and opacity 0.

On CUDA tensors the whole per-row chain is one kernel, ``project_fwd``
(``csrc/project.cu``), under one ``autograd.Function`` whose backward is
the kernel ``project_bwd``: autograd keeps no intermediate of the chain.
On CPU tensors ``project_gaussians_plain`` runs, the chain in PyTorch that
the kernel is held to; ``project_backward_plain`` is the backward kernel's
computation in PyTorch, line for line.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from .. import native
from ..core import sh as shlib
from ..core.camera import CameraParams, ndc_to_pixel
from ..core.covariance import (LOW_PASS, camera_cov3d, conic_and_radius,
                               project_cov3d)
from ..core.quaternion import to_rotation_matrix
from ..profiling import count, span, sync_point

# Near-plane distance used for frustum culling.
NEAR_CULL = 0.2


class Projected(NamedTuple):
    """Screen-space Gaussian attributes, one row per (possibly culled) input."""

    mean2d: torch.Tensor     # [N, 2] pixel coordinates
    depth: torch.Tensor      # [N] camera-space z (+inf when culled)
    inv_depth: torch.Tensor  # [N] 1/z
    conic: torch.Tensor      # [N, 3] inverse 2D covariance (a, b, c)
    radius: torch.Tensor     # [N] pixel radius (0 => culled)
    color: torch.Tensor      # [N, 3] view-dependent RGB
    opacity: torch.Tensor    # [N] activated opacity
    valid: torch.Tensor      # [N] bool visibility mask


def project_gaussians(
    means3d: torch.Tensor,         # [N, 3]
    scales: torch.Tensor,          # [N, 3] activated scales
    quats: torch.Tensor,           # [N, 4] wxyz (normalized inside)
    opacities: torch.Tensor,       # [N] activated opacities
    sh_coeffs: torch.Tensor,       # [N, K, 3]
    camera: CameraParams,
    sh_degree: int,
    scale_modifier: float = 1.0,
    active_mask: torch.Tensor | None = None,
) -> Projected:
    """Launches ``project_fwd`` on CUDA tensors (``project_bwd`` under
    autograd); runs ``project_gaussians_plain`` on CPU tensors."""
    with span("raster.project"):
        if means3d.is_cuda:
            return _project_kernel(means3d, scales, quats, opacities,
                                   sh_coeffs, camera, sh_degree,
                                   scale_modifier, active_mask)
        if means3d.device.type != "cpu":
            raise RuntimeError(
                f"project_gaussians: no kernel for {means3d.device}")
        return project_gaussians_plain(means3d, scales, quats, opacities,
                                       sh_coeffs, camera, sh_degree,
                                       scale_modifier, active_mask)


def project_gaussians_plain(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    sh_coeffs: torch.Tensor,
    camera: CameraParams,
    sh_degree: int,
    scale_modifier: float = 1.0,
    active_mask: torch.Tensor | None = None,
) -> Projected:
    """The plain PyTorch version of ``project_gaussians`` (same arguments
    and result), differentiated by autograd."""
    n = means3d.shape[0]
    ones = torch.ones((n, 1), dtype=means3d.dtype, device=means3d.device)
    hom = torch.cat([means3d, ones], dim=1)                 # [N, 4]

    # Full-f32 products (TF32 stays off: see chip_smoke.py's precision
    # check).
    p_view = hom @ camera.viewmatrix.T                      # [N, 4]
    depth = p_view[:, 2]

    p_clip = hom @ camera.projmatrix.T
    w = p_clip[:, 3]
    w_safe = torch.where(torch.abs(w) > 1e-7, w, torch.full_like(w, 1e-7))
    ndc = p_clip[:, :2] / w_safe[:, None]

    # A copy from pageable host memory: the host waits for the device.
    with sync_point("project_size"):
        size = torch.tensor([float(camera.width), float(camera.height)],
                            dtype=torch.float32, device=means3d.device)
    mean2d = ndc_to_pixel(ndc, size)

    cov_cam = camera_cov3d(scales, quats, camera.viewmatrix[:3, :3],
                           scale_modifier)
    cov2d = project_cov3d(cov_cam, p_view[:, :3],
                          camera.focal_x, camera.focal_y,
                          camera.tan_fovx, camera.tan_fovy)
    conic, radius, det = conic_and_radius(cov2d)

    valid = (depth > NEAR_CULL) & (det > 0.0)
    if active_mask is not None:
        valid = valid & active_mask
    in_image = (
        (mean2d[:, 0] + radius >= 0.0)
        & (mean2d[:, 0] - radius <= camera.width)
        & (mean2d[:, 1] + radius >= 0.0)
        & (mean2d[:, 1] - radius <= camera.height)
    )
    valid = valid & in_image & (radius > 0.0)

    color = shlib.sh_to_color(sh_degree, sh_coeffs, means3d, camera.campos)

    zero = torch.zeros_like(depth)
    radius = torch.where(valid, radius, zero)
    depth_safe = torch.clamp(depth, min=1e-6)
    return Projected(
        mean2d=mean2d,
        depth=torch.where(valid, depth,
                          torch.full_like(depth, float("inf"))),
        inv_depth=torch.where(valid, 1.0 / depth_safe, zero),
        conic=conic,
        radius=radius,
        color=color,
        opacity=torch.where(valid, opacities, zero),
        valid=valid,
    )


# ---------------------------------------------------------------------------
# The kernel pair


_CAMERA_FIELDS = ("viewmatrix", "projmatrix", "campos", "tan_fovx",
                  "tan_fovy", "focal_x", "focal_y")
_CAMERA_SHAPES = ((4, 4), (4, 4), (3,), (), (), (), ())


def _camera_tensors(camera: CameraParams, dev: torch.device) -> list:
    """The camera tensors in the kernels' order, each contiguous (a no-op
    for the cameras ``core/camera.make_camera`` builds)."""
    out = []
    for name, shape in zip(_CAMERA_FIELDS, _CAMERA_SHAPES):
        t = getattr(camera, name)
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 or \
                tuple(t.shape) != shape or t.device != dev:
            raise ValueError(
                f"project_gaussians: camera.{name} must be a float32 tensor "
                f"of shape {shape} on {dev}")
        if t.requires_grad:
            raise ValueError(f"project_gaussians: camera.{name} requires "
                             "grad; the kernel gives no camera gradient")
        out.append(t.contiguous())
    return out


def _project_kernel(means3d, scales, quats, opacities, sh_coeffs, camera,
                    sh_degree, scale_modifier, active_mask) -> Projected:
    dev = means3d.device
    n = means3d.shape[0]
    if not 0 <= sh_degree <= 4:
        raise ValueError(f"project_gaussians: SH degree must be in [0, 4], "
                         f"got {sh_degree}")
    k = sh_coeffs.shape[1] if sh_coeffs.dim() == 3 else -1
    for name, x, shape in (("means3d", means3d, (n, 3)),
                           ("scales", scales, (n, 3)),
                           ("quats", quats, (n, 4)),
                           ("opacities", opacities, (n,)),
                           ("sh_coeffs", sh_coeffs, (n, k, 3))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape or \
                x.device != dev:
            raise ValueError(f"project_gaussians: {name} must be a float32 "
                             f"tensor of shape {shape} on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if k < shlib.num_sh_coeffs(sh_degree):
        raise ValueError(f"project_gaussians: degree {sh_degree} needs "
                         f"{shlib.num_sh_coeffs(sh_degree)} SH coefficients, "
                         f"got {k}")
    if active_mask is not None and (active_mask.dtype != torch.bool or
                                    tuple(active_mask.shape) != (n,) or
                                    active_mask.device != dev):
        raise ValueError("project_gaussians: active_mask must be a bool "
                         f"tensor of shape {(n,)} on {dev}")
    count("project.rows", n)
    out = _Project.apply(means3d.contiguous(), scales.contiguous(),
                         quats.contiguous(), opacities.contiguous(),
                         sh_coeffs.contiguous(),
                         None if active_mask is None
                         else active_mask.contiguous(),
                         camera, int(sh_degree), float(scale_modifier))
    return Projected(*out)


def _ptr(x: torch.Tensor | None) -> int | None:
    return None if x is None else x.data_ptr()


class _Project(torch.autograd.Function):
    """``project_fwd`` under autograd, ``project_bwd`` its backward.  Saves
    references to its inputs and the mask alone; the backward recomputes
    the chain row by row."""

    @staticmethod
    def forward(ctx, means3d, scales, quats, opacities, sh_coeffs,
                active_mask, camera, sh_degree, scale_modifier):
        dev = means3d.device
        n, k = means3d.shape[0], sh_coeffs.shape[1]
        cam = _camera_tensors(camera, dev)
        f32 = torch.float32
        mean2d = torch.empty((n, 2), dtype=f32, device=dev)
        depth = torch.empty(n, dtype=f32, device=dev)
        inv_depth = torch.empty(n, dtype=f32, device=dev)
        conic = torch.empty((n, 3), dtype=f32, device=dev)
        radius = torch.empty(n, dtype=f32, device=dev)
        color = torch.empty((n, 3), dtype=f32, device=dev)
        opacity = torch.empty(n, dtype=f32, device=dev)
        valid = torch.empty(n, dtype=torch.bool, device=dev)
        native.launch("project_fwd", means3d.data_ptr(), scales.data_ptr(),
                      quats.data_ptr(), opacities.data_ptr(),
                      sh_coeffs.data_ptr(), _ptr(active_mask),
                      *(t.data_ptr() for t in cam), n, k,
                      sh_degree, camera.width, camera.height, scale_modifier,
                      mean2d.data_ptr(), depth.data_ptr(),
                      inv_depth.data_ptr(), conic.data_ptr(),
                      radius.data_ptr(), color.data_ptr(),
                      opacity.data_ptr(), valid.data_ptr())
        ctx.save_for_backward(means3d, scales, quats, sh_coeffs, active_mask)
        ctx.camera = camera
        ctx.meta = (sh_degree, scale_modifier)
        ctx.mark_non_differentiable(radius, valid)
        ctx.set_materialize_grads(False)
        return mean2d, depth, inv_depth, conic, radius, color, opacity, valid

    @staticmethod
    @once_differentiable
    def backward(ctx, g_mean2d, g_depth, g_inv_depth, g_conic, _g_radius,
                 g_color, g_opacity, _g_valid):
        means3d, scales, quats, sh_coeffs, active_mask = ctx.saved_tensors
        sh_degree, scale_modifier = ctx.meta
        dev = means3d.device
        n, k = means3d.shape[0], sh_coeffs.shape[1]
        need = ctx.needs_input_grad

        def cot(g):
            return None if g is None else g.to(torch.float32).contiguous()

        def grad(i, like):
            return torch.empty_like(like) if need[i] else None

        cots = [cot(g) for g in (g_mean2d, g_depth, g_inv_depth, g_conic,
                                 g_color, g_opacity)]
        grads = [grad(0, means3d), grad(1, scales), grad(2, quats),
                 torch.empty(n, dtype=torch.float32, device=dev)
                 if need[3] else None, grad(4, sh_coeffs)]
        cam = _camera_tensors(ctx.camera, dev)
        native.launch("project_bwd", means3d.data_ptr(), scales.data_ptr(),
                      quats.data_ptr(), sh_coeffs.data_ptr(),
                      _ptr(active_mask), *(t.data_ptr() for t in cam), n,
                      k, sh_degree, ctx.camera.width, ctx.camera.height,
                      scale_modifier, *(_ptr(g) for g in cots),
                      *(_ptr(g) for g in grads))
        return (*grads, None, None, None, None)


def project_backward_plain(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    sh_coeffs: torch.Tensor,
    camera: CameraParams,
    sh_degree: int,
    scale_modifier: float = 1.0,
    active_mask: torch.Tensor | None = None,
    g_mean2d: torch.Tensor | None = None,
    g_depth: torch.Tensor | None = None,
    g_inv_depth: torch.Tensor | None = None,
    g_conic: torch.Tensor | None = None,
    g_color: torch.Tensor | None = None,
    g_opacity: torch.Tensor | None = None,
):
    """The backward of ``project_gaussians`` as ``project_bwd`` computes it,
    in PyTorch, line for line: the row's forward recomputed from the inputs,
    then the chain rule with autograd's conventions at branch points.  The
    cotangents (of ``mean2d``, ``depth``, ``inv_depth``, ``conic``,
    ``color`` and ``opacity``) may each be None (zero).  Returns the
    gradients of (means3d, scales, quats, opacities, sh_coeffs); those of
    SH coefficients past (degree + 1)^2 are zero."""
    V, P = camera.viewmatrix, camera.projmatrix
    width, height = float(camera.width), float(camera.height)
    x, y, z = means3d.unbind(-1)
    zero = torch.zeros_like(x)

    def cot(g, cols=None):
        if g is None:
            return zero if cols is None else [zero] * cols
        return g if cols is None else list(g.unbind(-1))

    def where(cond, a, b):
        return torch.where(cond, a, b)

    # The forward, as geometry() in the kernel.
    vx = V[0, 0] * x + V[0, 1] * y + V[0, 2] * z + V[0, 3]
    vy = V[1, 0] * x + V[1, 1] * y + V[1, 2] * z + V[1, 3]
    vz = V[2, 0] * x + V[2, 1] * y + V[2, 2] * z + V[2, 3]
    cx = P[0, 0] * x + P[0, 1] * y + P[0, 2] * z + P[0, 3]
    cy = P[1, 0] * x + P[1, 1] * y + P[1, 2] * z + P[1, 3]
    cw = P[3, 0] * x + P[3, 1] * y + P[3, 2] * z + P[3, 3]
    ws = where(torch.abs(cw) > 1e-7, cw, torch.full_like(cw, 1e-7))
    m2x = ((cx / ws + 1.0) * width - 1.0) * 0.5
    m2y = ((cy / ws + 1.0) * height - 1.0) * 0.5

    qn = torch.linalg.vector_norm(quats, dim=-1)
    qc = torch.clamp(qn, min=1e-12)
    qw, qx, qy, qz = (quats / qc[:, None]).unbind(-1)
    R = to_rotation_matrix(quats)
    s = scales * scale_modifier
    a = [[V[i, 0] * R[:, 0, j] * s[:, j] + V[i, 1] * R[:, 1, j] * s[:, j]
          + V[i, 2] * R[:, 2, j] * s[:, j] for j in range(3)]
         for i in range(3)]

    def dot(i, j):
        return a[i][0] * a[j][0] + a[i][1] * a[j][1] + a[i][2] * a[j][2]

    c00, c01, c02 = dot(0, 0), dot(0, 1), dot(0, 2)
    c11, c12, c22 = dot(1, 1), dot(1, 2), dot(2, 2)

    lim_x = 1.3 * camera.tan_fovx
    lim_y = 1.3 * camera.tan_fovy
    tzs = torch.clamp(vz, min=1e-6)
    ux, uy = vx / tzs, vy / tzs
    cux = torch.clamp(ux, -lim_x, lim_x)
    cuy = torch.clamp(uy, -lim_y, lim_y)
    txz, tyz = cux * tzs, cuy * tzs
    inv_z = 1.0 / tzs
    inv_z2 = inv_z * inv_z
    fx, fy = camera.focal_x, camera.focal_y
    j00 = fx * inv_z
    j02 = -fx * txz * inv_z2
    j11 = fy * inv_z
    j12 = -fy * tyz * inv_z2
    t00 = j00 * c00 + j02 * c02
    t01 = j00 * c01 + j02 * c12
    t02 = j00 * c02 + j02 * c22
    t10 = j11 * c01 + j12 * c02
    t11 = j11 * c11 + j12 * c12
    t12 = j11 * c12 + j12 * c22
    cxx = t00 * j00 + t02 * j02 + LOW_PASS
    cxy = t00 * 0.0 + t01 * j11 + t02 * j12
    cyy = t10 * 0.0 + t11 * j11 + t12 * j12 + LOW_PASS

    det = cxx * cyy - cxy * cxy
    inv_det = 1.0 / where(det > 0.0, det, torch.ones_like(det))
    mid = 0.5 * (cxx + cyy)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(mid + disc, min=0.0)))
    in_image = ((m2x + radius >= 0.0) & (m2x - radius <= width)
                & (m2y + radius >= 0.0) & (m2y - radius <= height))
    valid = (vz > NEAR_CULL) & (det > 0.0) & in_image & (radius > 0.0)
    if active_mask is not None:
        valid = valid & active_mask

    # Masked outputs: opacity, depth, inverse depth.
    d_opacities = where(valid, cot(g_opacity), zero)
    inv_d = 1.0 / torch.clamp(vz, min=1e-6)
    g_ds = -cot(g_inv_depth) * (inv_d * inv_d)
    g_vz = where(valid, cot(g_depth) + where(vz >= 1e-6, g_ds, zero), zero)

    # mean2d -> NDC -> clip.
    g_m2x, g_m2y = cot(g_mean2d, 2)
    g_ndc_x = g_m2x * 0.5 * width
    g_ndc_y = g_m2y * 0.5 * height
    g_cx, g_cy = g_ndc_x / ws, g_ndc_y / ws
    ws2 = ws * ws
    g_ws = -g_ndc_x * cx / ws2 + -g_ndc_y * cy / ws2
    g_cw = where(torch.abs(cw) > 1e-7, g_ws, zero)

    # conic -> packed 2D covariance.
    g_c0, g_c1, g_c2 = cot(g_conic, 3)
    g_inv_det = g_c0 * cyy + g_c1 * -cxy + g_c2 * cxx
    g_cyy = g_c0 * inv_det
    g_cxy = -(g_c1 * inv_det)
    g_cxx = g_c2 * inv_det
    g_det = where(det > 0.0, -g_inv_det * (inv_det * inv_det), zero)
    g_cxx = g_cxx + g_det * cyy
    g_cyy = g_cyy + g_det * cxx
    g_cxy = g_cxy - 2.0 * (g_det * cxy)

    # EWA: J and the camera-space covariance.
    g_t00 = g_cxx * j00 + g_cxy * 0.0
    g_t02 = g_cxx * j02 + g_cxy * j12
    g_t01 = g_cxy * j11
    g_t10 = g_cyy * 0.0
    g_t11 = g_cyy * j11
    g_t12 = g_cyy * j12
    g_j00 = g_cxx * t00 + g_t00 * c00 + g_t01 * c01 + g_t02 * c02
    g_j02 = g_cxx * t02 + g_t00 * c02 + g_t01 * c12 + g_t02 * c22
    g_j11 = (g_cxy * t01 + g_cyy * t11 + g_t10 * c01 + g_t11 * c11
             + g_t12 * c12)
    g_j12 = (g_cxy * t02 + g_cyy * t12 + g_t10 * c02 + g_t11 * c12
             + g_t12 * c22)
    g_d00 = g_t00 * j00
    g_d01 = g_t01 * j00 + g_t10 * j11
    g_d02 = g_t02 * j00 + (g_t00 * j02 + g_t10 * j12)
    g_d11 = g_t11 * j11
    g_d12 = g_t12 * j11 + (g_t01 * j02 + g_t11 * j12)
    g_d22 = g_t02 * j02 + g_t12 * j12

    g_inv_z2 = g_j02 * (-fx * txz) + g_j12 * (-fy * tyz)
    g_txz = g_j02 * inv_z2 * -fx
    g_tyz = g_j12 * inv_z2 * -fy
    g_inv_z = g_j00 * fx + g_j11 * fy + 2.0 * (g_inv_z2 * inv_z)
    g_tzs = -g_inv_z * (inv_z * inv_z)
    g_tzs = g_tzs + g_txz * cux + g_tyz * cuy
    g_ux = where((ux >= -lim_x) & (ux <= lim_x), g_txz * tzs, zero)
    g_uy = where((uy >= -lim_y) & (uy <= lim_y), g_tyz * tzs, zero)
    tzs2 = tzs * tzs
    g_vx, g_vy = g_ux / tzs, g_uy / tzs
    g_tzs = g_tzs + (-g_ux * vx / tzs2 + -g_uy * vy / tzs2)
    g_vz = g_vz + where(vz >= 1e-6, g_tzs, zero)

    # Sigma = a a^T -> a -> (R, s).
    gd = [[g_d00, g_d01, g_d02], [g_d01, g_d11, g_d12],
          [g_d02, g_d12, g_d22]]
    g_a = [[None] * 3 for _ in range(3)]
    for r in range(3):
        for kk in range(3):
            acc = 2.0 * (gd[r][r] * a[r][kk])
            for j in range(3):
                if j != r:
                    acc = acc + gd[r][j] * a[j][kk]
            g_a[r][kk] = acc
    g_R = [[zero] * 3 for _ in range(3)]
    g_s = [zero] * 3
    for j in range(3):
        for r in range(3):
            ga = g_a[r][j]
            for kk in range(3):
                g_R[kk][j] = g_R[kk][j] + ga * s[:, j] * V[r, kk]
                g_s[j] = g_s[j] + ga * (V[r, kk] * R[:, kk, j])
    d_scales = torch.stack(g_s, dim=-1) * scale_modifier

    # R -> the normalised quaternion -> q.
    gR = [g_R[0][0], g_R[0][1], g_R[0][2], g_R[1][0], g_R[1][1], g_R[1][2],
          g_R[2][0], g_R[2][1], g_R[2][2]]
    g_w = 2.0 * (-qz * gR[1] + qy * gR[2] + qz * gR[3] - qx * gR[5]
                 - qy * gR[6] + qx * gR[7])
    g_x = 2.0 * (qy * gR[1] + qz * gR[2] + qy * gR[3] - 2.0 * qx * gR[4]
                 - qw * gR[5] + qz * gR[6] + qw * gR[7] - 2.0 * qx * gR[8])
    g_y = 2.0 * (-2.0 * qy * gR[0] + qx * gR[1] + qw * gR[2] + qx * gR[3]
                 + qz * gR[5] - qw * gR[6] + qz * gR[7] - 2.0 * qy * gR[8])
    g_z = 2.0 * (-2.0 * qz * gR[0] - qw * gR[1] + qx * gR[2] + qw * gR[3]
                 - 2.0 * qz * gR[4] + qy * gR[5] + qx * gR[6] + qy * gR[7])
    g_qn4 = torch.stack([g_w, g_x, g_y, g_z], dim=-1)
    g_qc = -(g_qn4 * quats).sum(-1) / (qc * qc)
    g_qn = where(qn >= 1e-12, g_qc, zero)
    norm_scale = where(qn != 0.0, g_qn / torch.where(qn != 0.0, qn, 1.0),
                       zero)
    d_quats = g_qn4 / qc[:, None] + quats * norm_scale[:, None]

    # Colour: clamp, SH sum, basis, unit direction.
    kd = shlib.num_sh_coeffs(sh_degree)
    dvec = means3d - camera.campos
    n = torch.linalg.vector_norm(dvec, dim=-1)
    nc = torch.clamp(n, min=1e-12)
    dirs = dvec / nc[:, None]
    b = shlib.sh_basis(sh_degree, dirs)                       # [N, kd]
    c = sh_coeffs[:, :kd, :]
    e = (b[:, :, None] * c).sum(1)                            # [N, 3]
    ge = where(e + 0.5 >= 0.0, cot(g_color) if g_color is not None
               else torch.zeros_like(e), torch.zeros_like(e))
    gb = (ge[:, None, :] * c).sum(-1)                         # [N, kd]
    d_sh = torch.zeros_like(sh_coeffs)
    d_sh[:, :kd, :] = ge[:, None, :] * b[:, :, None]
    g_dir = sh_basis_grad(sh_degree, dirs, gb)                # [N, 3]
    g_nc = -(g_dir * dvec).sum(-1) / (nc * nc)
    g_n = where(n >= 1e-12, g_nc, zero)
    n_scale = where(n != 0.0, g_n / torch.where(n != 0.0, n, 1.0), zero)
    g_d = g_dir / nc[:, None] + dvec * n_scale[:, None]

    d_means = torch.stack([
        (g_vx * V[0, kk] + g_vy * V[1, kk] + g_vz * V[2, kk])
        + (g_cx * P[0, kk] + g_cy * P[1, kk] + g_cw * P[3, kk])
        + g_d[:, kk] for kk in range(3)], dim=-1)
    return d_means, d_scales, d_quats, d_opacities, d_sh


def sh_basis_grad(degree: int, dirs: torch.Tensor,
                  gb: torch.Tensor) -> torch.Tensor:
    """[N, 3]: the gradient of sum_k gb[:, k] * b_k(dirs) with respect to
    the directions ``dirs`` [N, 3], ``gb`` [N, (degree+1)**2], from each
    basis polynomial's partial derivatives (``csrc/project.cu``
    ``sh_basis_grad``)."""
    x, y, z = dirs.unbind(-1)
    gx = torch.zeros_like(x)
    gy = torch.zeros_like(x)
    gz = torch.zeros_like(x)
    C1, C2, C3, C4 = shlib.C1, shlib.C2, shlib.C3, shlib.C4
    g = gb.unbind(-1)
    if degree >= 1:
        gy = gy + g[1] * -C1
        gz = gz + g[2] * C1
        gx = gx + g[3] * -C1
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        gx = gx + g[4] * (C2[0] * y)
        gy = gy + g[4] * (C2[0] * x)
        gy = gy + g[5] * (C2[1] * z)
        gz = gz + g[5] * (C2[1] * y)
        gx = gx + g[6] * (C2[2] * (-2.0 * x))
        gy = gy + g[6] * (C2[2] * (-2.0 * y))
        gz = gz + g[6] * (C2[2] * (4.0 * z))
        gx = gx + g[7] * (C2[3] * z)
        gz = gz + g[7] * (C2[3] * x)
        gx = gx + g[8] * (C2[4] * (2.0 * x))
        gy = gy + g[8] * (C2[4] * (-2.0 * y))
    if degree >= 3:
        gx = gx + g[9] * (C3[0] * (6.0 * x * y))
        gy = gy + g[9] * (C3[0] * (3.0 * xx - 3.0 * yy))
        gx = gx + g[10] * (C3[1] * (y * z))
        gy = gy + g[10] * (C3[1] * (x * z))
        gz = gz + g[10] * (C3[1] * (x * y))
        gx = gx + g[11] * (C3[2] * (-2.0 * x * y))
        gy = gy + g[11] * (C3[2] * (4.0 * zz - xx - 3.0 * yy))
        gz = gz + g[11] * (C3[2] * (8.0 * y * z))
        gx = gx + g[12] * (C3[3] * (-6.0 * x * z))
        gy = gy + g[12] * (C3[3] * (-6.0 * y * z))
        gz = gz + g[12] * (C3[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy))
        gx = gx + g[13] * (C3[4] * (4.0 * zz - 3.0 * xx - yy))
        gy = gy + g[13] * (C3[4] * (-2.0 * x * y))
        gz = gz + g[13] * (C3[4] * (8.0 * x * z))
        gx = gx + g[14] * (C3[5] * (2.0 * x * z))
        gy = gy + g[14] * (C3[5] * (-2.0 * y * z))
        gz = gz + g[14] * (C3[5] * (xx - yy))
        gx = gx + g[15] * (C3[6] * (3.0 * xx - 3.0 * yy))
        gy = gy + g[15] * (C3[6] * (-6.0 * x * y))
    if degree >= 4:
        gx = gx + g[16] * (C4[0] * (y * (3.0 * xx - yy)))
        gy = gy + g[16] * (C4[0] * (x * (xx - 3.0 * yy)))
        gx = gx + g[17] * (C4[1] * (6.0 * x * y * z))
        gy = gy + g[17] * (C4[1] * (3.0 * z * (xx - yy)))
        gz = gz + g[17] * (C4[1] * (y * (3.0 * xx - yy)))
        gx = gx + g[18] * (C4[2] * (y * (7.0 * zz - 1.0)))
        gy = gy + g[18] * (C4[2] * (x * (7.0 * zz - 1.0)))
        gz = gz + g[18] * (C4[2] * (14.0 * x * y * z))
        gy = gy + g[19] * (C4[3] * (z * (7.0 * zz - 3.0)))
        gz = gz + g[19] * (C4[3] * (y * (21.0 * zz - 3.0)))
        gz = gz + g[20] * (C4[4] * (z * (140.0 * zz - 60.0)))
        gx = gx + g[21] * (C4[5] * (z * (7.0 * zz - 3.0)))
        gz = gz + g[21] * (C4[5] * (x * (21.0 * zz - 3.0)))
        gx = gx + g[22] * (C4[6] * (2.0 * x * (7.0 * zz - 1.0)))
        gy = gy + g[22] * (C4[6] * (-2.0 * y * (7.0 * zz - 1.0)))
        gz = gz + g[22] * (C4[6] * (14.0 * z * (xx - yy)))
        gx = gx + g[23] * (C4[7] * (3.0 * z * (xx - yy)))
        gy = gy + g[23] * (C4[7] * (-6.0 * x * y * z))
        gz = gz + g[23] * (C4[7] * (x * (xx - 3.0 * yy)))
        gx = gx + g[24] * (C4[8] * (4.0 * x * (xx - 3.0 * yy)))
        gy = gy + g[24] * (C4[8] * (4.0 * y * (yy - 3.0 * xx)))
    return torch.stack([gx, gy, gz], dim=-1)
