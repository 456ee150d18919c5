"""Inputs of every cell, made from ``--seed`` by the benchmark itself: the
street chunk's Gaussian rows, the cameras, the training targets and the
LOD hierarchy over the chunk.  Nothing here imports the program: the
program and the reference are handed the same tensors.

The street profile follows the port's ``make_street_scene`` layout
(ground strip, two facades, clustered objects, far background,
log-uniform angular splat sizes), with the object clusters beside the
driving lanes rather than across the road, drawn on the device with one
``torch.Generator`` in a few large calls.  Beta(4, 1.5) opacities come
from gamma draws built of uniforms and normals: Gamma(4) is a sum of four
exponentials, Gamma(1.5) one exponential plus half a squared normal.

The hierarchy builder follows the port's ``hierarchy/build.py``: a Morton
(Z-order) leaf order, a binary tree by pairing consecutive nodes level by
level, parents moment-matched from their children (opacity x volume
weights, mass-preserving opacity, scales and rotation from the merged
covariance's eigendecomposition), subtree AABBs and the world-size cut
metric, all on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

_EPS = 1e-12


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    return g


def street_rows(g: torch.Generator, n: int, sh_degree: int, length: float,
                half_width: float, device, regular_objects: bool = False
                ) -> dict:
    """Activated rows of one street chunk: means [n, 3], scales [n, 3],
    quats [n, 4] (unit, wxyz), opacities [n], sh [n, K, 3].  With
    ``regular_objects`` the object clusters stand evenly along the road,
    alternating sides, 6 m off its axis and 1.5 m up, so that every seed
    puts them in the same places."""
    def u(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)

    def nrm(shape, s=1.0):
        return s * torch.randn(shape, generator=g, device=device)

    n_ground, n_facade, n_obj = int(n * 0.40), int(n * 0.40), int(n * 0.15)
    n_far = n - n_ground - n_facade - n_obj
    ground = torch.stack([u(n_ground, 0.0, length),
                          u(n_ground, -half_width, half_width),
                          nrm(n_ground, 0.03).abs()], 1)
    side = torch.randint(0, 2, (n_facade,), generator=g, device=device) * 2 - 1
    facade = torch.stack([u(n_facade, 0.0, length),
                          side * half_width + nrm(n_facade, 0.15),
                          u(n_facade, 0.0, 14.0)], 1)
    n_clusters = max(1, n_obj // 2000)
    # Objects stand beside the driving lanes (parked cars, poles, trees),
    # not on the capture vehicle's path.
    c_side = torch.randint(0, 2, (n_clusters,), generator=g,
                           device=device) * 2 - 1
    centers = torch.stack([u(n_clusters, 0.0, length),
                           c_side * u(n_clusters, 3.5, 0.8 * half_width),
                           u(n_clusters, 0.3, 3.0)], 1)
    if regular_objects:
        k = torch.arange(n_clusters, device=device)
        centers = torch.stack([(k + 0.5) * length / n_clusters,
                               (1 - 2 * (k % 2)) * 6.0,
                               torch.full((n_clusters,), 1.5, device=device)],
                              1)
    which = torch.randint(0, n_clusters, (n_obj,), generator=g, device=device)
    objs = centers[which] + nrm((n_obj, 3)) * torch.tensor(
        [1.5, 0.6, 0.8], device=device)
    objs[:, 2] = objs[:, 2].abs()
    far = torch.stack([u(n_far, length, 1.6 * length),
                       u(n_far, -6 * half_width, 6 * half_width),
                       u(n_far, 0.0, 30.0)], 1)
    means = torch.cat([ground, facade, objs, far])

    t_ax = means[:, 0].clamp(0.0, length)
    d_ax = torch.sqrt((means[:, 0] - t_ax) ** 2 + means[:, 1] ** 2
                      + (means[:, 2] - 2.2) ** 2).clamp(1.5, 300.0)
    theta = torch.exp(u((n, 3), math.log(1e-3), math.log(6e-3)))
    scales = d_ax[:, None] * theta
    scales[:n_ground, 2] *= 0.15
    scales[n_ground:n_ground + n_facade, 1] *= 0.15
    scales[n - n_far:] *= 2.0
    quats = nrm((n, 4))
    quats = quats / quats.norm(dim=1, keepdim=True).clamp(min=_EPS)
    e = -torch.log(u((n, 5), 1e-12, 1.0))
    x = e[:, :4].sum(1)
    y = e[:, 4] + 0.5 * nrm(n) ** 2
    opac = x / (x + y) * 0.98 + 0.01
    k = (sh_degree + 1) ** 2
    sh = nrm((n, k, 3), 0.12)
    sh[:, 0, :] = u((n, 3), -1.2, 1.2)
    return dict(means=means, scales=scales, quats=quats, opacities=opac,
                sh=sh)


# ---------------------------------------------------------------------------
# Cameras: 4x4 world->view and full projection matrices, column vectors.


def _projection(znear, zfar, fovx, fovy) -> np.ndarray:
    top = math.tan(fovy / 2.0) * znear
    right = math.tan(fovx / 2.0) * znear
    P = np.zeros((4, 4))
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def camera(pos, yaw: float, pitch: float, width: int, height: int,
           fovx_deg: float, znear: float = 0.01, zfar: float = 1000.0
           ) -> dict:
    """A pinhole camera at ``pos`` looking along (yaw, pitch), world up +z,
    3DGS camera frame (+z forward, +y down).  numpy float32 matrices."""
    cp, sp = math.cos(pitch), math.sin(pitch)
    fwd = np.array([cp * math.cos(yaw), cp * math.sin(yaw), sp])
    right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    r_wc = np.stack([right, down, fwd])
    view = np.eye(4)
    view[:3, :3] = r_wc
    view[:3, 3] = -r_wc @ np.asarray(pos, np.float64)
    fovx = math.radians(fovx_deg)
    fovy = 2.0 * math.atan(math.tan(fovx / 2.0) * height / width)
    proj = _projection(znear, zfar, fovx, fovy) @ view
    return dict(view=view.astype(np.float32), proj=proj.astype(np.float32),
                campos=np.asarray(pos, np.float32),
                tan_fovx=math.tan(fovx / 2.0), tan_fovy=math.tan(fovy / 2.0),
                focal_x=width / (2.0 * math.tan(fovx / 2.0)),
                focal_y=height / (2.0 * math.tan(fovy / 2.0)),
                width=int(width), height=int(height))


def smooth_field(g: torch.Generator, channels: int, height: int, width: int,
                 device, cell: int = 64) -> torch.Tensor:
    """[channels, height, width] values in [0, 1]: uniform noise on a grid
    of ``cell``-pixel cells, bilinearly upsampled."""
    low = torch.rand((1, channels, -(-height // cell) + 1,
                      -(-width // cell) + 1), generator=g, device=device)
    return F.interpolate(low, size=(height, width), mode="bilinear",
                         align_corners=False)[0]


# ---------------------------------------------------------------------------
# The LOD hierarchy


def morton_order(xyz: torch.Tensor, bits: int = 21) -> torch.Tensor:
    lo = xyz.min(0).values
    hi = xyz.max(0).values
    q = ((xyz - lo) / (hi - lo).clamp(min=_EPS) * ((1 << bits) - 1)).to(
        torch.int64)

    def spread(v):
        v = v & ((1 << bits) - 1)
        v = (v | (v << 32)) & 0x1F00000000FFFF
        v = (v | (v << 16)) & 0x1F0000FF0000FF
        v = (v | (v << 8)) & 0x100F00F00F00F00F
        v = (v | (v << 4)) & 0x10C30C30C30C30C3
        v = (v | (v << 2)) & 0x1249249249249249
        return v

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return torch.sort(code, stable=True).indices


def rotation(quats: torch.Tensor) -> torch.Tensor:
    q = quats / quats.norm(dim=-1, keepdim=True).clamp(min=_EPS)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def _rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Shepperd's method, the max-trace candidate, branch-free."""
    m = R
    qw = torch.sqrt((1 + m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2]).clamp(min=0)) / 2
    qx = torch.sqrt((1 + m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2]).clamp(min=0)) / 2
    qy = torch.sqrt((1 - m[:, 0, 0] + m[:, 1, 1] - m[:, 2, 2]).clamp(min=0)) / 2
    qz = torch.sqrt((1 - m[:, 0, 0] - m[:, 1, 1] + m[:, 2, 2]).clamp(min=0)) / 2
    q = torch.stack([qw, qx, qy, qz], -1)
    i = q.argmax(-1)
    a = m[:, 2, 1] - m[:, 1, 2]
    b = m[:, 0, 2] - m[:, 2, 0]
    c = m[:, 1, 0] - m[:, 0, 1]
    d = m[:, 0, 1] + m[:, 1, 0]
    e = m[:, 0, 2] + m[:, 2, 0]
    f = m[:, 1, 2] + m[:, 2, 1]
    one = torch.ones_like(a)
    sign = torch.stack([
        torch.stack([one, a, b, c], -1),            # w largest
        torch.stack([a, one, d, e], -1),            # x largest
        torch.stack([b, d, one, f], -1),            # y largest
        torch.stack([c, e, f, one], -1)], 1)        # z largest
    s = torch.sign(sign[torch.arange(R.shape[0], device=R.device), i])
    s = torch.where(s == 0, one[:, None], s)
    q = q * s
    return q / q.norm(dim=-1, keepdim=True).clamp(min=_EPS)


def eigh3(a: torch.Tensor, sweeps: int = 8):
    """Eigenvalues [N, 3] and eigenvectors [N, 3, 3] (columns) of
    symmetric 3x3 matrices by cyclic Jacobi rotations, batched."""
    a = a.clone()
    v = torch.eye(3, dtype=a.dtype, device=a.device).expand_as(a).clone()
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            apq = a[:, p, q]
            tau = (a[:, q, q] - a[:, p, p]) / (2 * apq)
            t = torch.sign(tau) / (tau.abs() + torch.sqrt(1 + tau * tau))
            t = torch.where(tau == 0, torch.ones_like(t), t)
            t = torch.where(apq == 0, torch.zeros_like(t), t)
            c = 1 / torch.sqrt(1 + t * t)
            s = t * c
            j = torch.eye(3, dtype=a.dtype, device=a.device).repeat(
                a.shape[0], 1, 1)
            j[:, p, p] = c
            j[:, q, q] = c
            j[:, p, q] = s
            j[:, q, p] = -s
            a = j.transpose(1, 2) @ a @ j
            v = v @ j
    return torch.diagonal(a, dim1=1, dim2=2), v


def build_hierarchy(rows: dict) -> dict:
    """Binary LOD tree over activated leaf rows.  Returns the node arrays
    (raw parameter rows with the hierarchy's abs-opacity convention,
    ``parent``, ``child_start``, ``child_count``, ``box_center``,
    ``box_half``, ``size``) and ``depth``, the number of levels."""
    dev = rows["means"].device
    order = morton_order(rows["means"])
    xyz = rows["means"][order]
    scales = rows["scales"][order]
    quats = rows["quats"][order]
    sh = rows["sh"][order]
    opac = rows["opacities"][order]
    n_leaves = xyz.shape[0]
    M = rotation(quats) * scales[:, None, :]
    cov = M @ M.transpose(1, 2)
    weight = opac * torch.sqrt(torch.linalg.det(cov).clamp(min=_EPS))

    nodes = [dict(xyz=xyz, scales=scales, quats=quats, sh=sh, opac=opac)]
    ids = torch.arange(n_leaves, device=dev)
    parents, starts, counts = [], [torch.zeros(n_leaves, dtype=torch.int64,
                                               device=dev)], \
        [torch.zeros(n_leaves, dtype=torch.int64, device=dev)]
    next_id = n_leaves
    while xyz.shape[0] > 1:
        n = xyz.shape[0]
        p = n // 2
        w0, w1 = weight[0:2 * p:2], weight[1:2 * p:2]
        wsum = w0 + w1
        f0 = (w0 / wsum.clamp(min=_EPS))[:, None]
        f1 = (w1 / wsum.clamp(min=_EPS))[:, None]
        x0, x1 = xyz[0:2 * p:2], xyz[1:2 * p:2]
        mu = f0 * x0 + f1 * x1
        d0, d1 = x0 - mu, x1 - mu
        cv = (f0[..., None] * (cov[0:2 * p:2] + d0[:, :, None] * d0[:, None])
              + f1[..., None] * (cov[1:2 * p:2] + d1[:, :, None] * d1[:, None]))
        sh_p = f0[:, :, None] * sh[0:2 * p:2] + f1[:, :, None] * sh[1:2 * p:2]
        vol = torch.sqrt(torch.linalg.det(cv).clamp(min=_EPS))
        o_p = (wsum / vol.clamp(min=_EPS)).clamp(1e-4, 0.9999)
        ccount = torch.full((p,), 2, dtype=torch.int64, device=dev)
        if n % 2:
            mu = torch.cat([mu, xyz[-1:]])
            cv = torch.cat([cv, cov[-1:]])
            sh_p = torch.cat([sh_p, sh[-1:]])
            o_p = torch.cat([o_p, opac[-1:]])
            wsum = torch.cat([wsum, weight[-1:]])
            ccount = torch.cat([ccount, ccount.new_ones(1)])
        m = mu.shape[0]
        new_ids = next_id + torch.arange(m, device=dev)
        next_id += m
        parents.append((ids, new_ids.repeat_interleave(2)[:n]))
        starts.append(ids[0::2])
        counts.append(ccount)
        evals, evecs = eigh3(cv)
        evals = evals.clamp(min=1e-10)
        flip = torch.where(torch.linalg.det(evecs) < 0, -1.0, 1.0)
        evecs[:, :, 0] = evecs[:, :, 0] * flip[:, None]
        nodes.append(dict(xyz=mu, scales=torch.sqrt(evals),
                          quats=_rotmat_to_quat(evecs), sh=sh_p, opac=o_p))
        xyz, cov, sh, opac, weight, ids = mu, cv, sh_p, o_p, wsum, new_ids

    n_nodes = next_id
    parent = torch.full((n_nodes,), -1, dtype=torch.int64, device=dev)
    for child_ids, par in parents:
        parent[child_ids] = par
    cat = {k: torch.cat([lv[k] for lv in nodes]) for k in nodes[0]}
    child_start = torch.cat(starts)
    child_count = torch.cat(counts)

    lo = cat["xyz"].clone()
    hi = cat["xyz"].clone()
    half = 3.0 * cat["scales"][:n_leaves]
    lo[:n_leaves] -= half
    hi[:n_leaves] += half
    off = n_leaves
    for lv in nodes[1:]:
        m = lv["xyz"].shape[0]
        cs = child_start[off:off + m]
        two = (child_count[off:off + m] == 2)[:, None]
        c1 = (cs + 1).clamp(max=n_nodes - 1)
        lo[off:off + m] = torch.minimum(lo[cs], torch.where(two, lo[c1], lo[cs]))
        hi[off:off + m] = torch.maximum(hi[cs], torch.where(two, hi[c1], hi[cs]))
        off += m
    box_half = 0.5 * (hi - lo)
    opac = cat["opac"].clamp(1e-5, 1.0 - 1e-5)
    return dict(
        xyz=cat["xyz"], features_dc=cat["sh"][:, :1].contiguous(),
        features_rest=cat["sh"][:, 1:].contiguous(),
        log_scales=torch.log(cat["scales"].clamp(min=1e-10)),
        quats=cat["quats"], opacity_raw=opac[:, None],
        parent=parent.to(torch.int32), child_start=child_start.to(torch.int32),
        child_count=child_count.to(torch.int32),
        box_center=0.5 * (lo + hi), box_half=box_half,
        size=2.0 * box_half.max(1).values, depth=len(nodes))
