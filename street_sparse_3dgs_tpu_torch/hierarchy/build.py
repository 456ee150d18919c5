"""Hierarchy builder, a numpy copy of ``street_sparse_3dgs_tpu/hierarchy/
build.py`` that returns the port's ``Hierarchy``.

  1. order leaves along a Morton (Z-order) curve,
  2. build a balanced binary tree by pairing consecutive nodes level by
     level (sibling ranges contiguous by construction),
  3. moment-match each parent from its children (opacity·volume-weighted
     mean/covariance merge; scales/rotation from the merged covariance's
     eigendecomposition),
  4. compute subtree AABBs and the world-size cut metric,
  5. mark anchors: nodes whose whole subtree consists of scaffold rows.

Same arithmetic in the same order as the JAX package's builder, so both
give the same tree from the same rows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..models.gaussians import GaussianParams
from .structure import Hierarchy

_EPS = 1e-12


def morton_order(xyz: np.ndarray, bits: int = 21) -> np.ndarray:
    """Indices sorting points along a 3D Morton curve."""
    lo = xyz.min(axis=0)
    hi = xyz.max(axis=0)
    q = ((xyz - lo) / np.maximum(hi - lo, _EPS) * ((1 << bits) - 1)).astype(
        np.uint64)

    def spread(v):
        v &= np.uint64((1 << bits) - 1)
        v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
        return v

    code = (spread(q[:, 0]) << np.uint64(2)) | (spread(q[:, 1])
                                                << np.uint64(1)) | spread(
        q[:, 2])
    return np.argsort(code, kind="stable")


def _covariances(scales: np.ndarray, quats: np.ndarray) -> np.ndarray:
    """[N,3] activated scales + [N,4] wxyz -> [N,3,3] covariances."""
    q = quats / np.maximum(np.linalg.norm(quats, axis=-1, keepdims=True),
                           _EPS)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1),
    ], axis=-2)
    M = R * scales[:, None, :]
    return M @ np.swapaxes(M, -1, -2)


def _rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """Batched [N,3,3] rotation matrices -> [N,4] wxyz quaternions
    (Shepperd's method, branch-free via the max-trace candidate)."""
    m00, m01, m02 = R[:, 0, 0], R[:, 0, 1], R[:, 0, 2]
    m10, m11, m12 = R[:, 1, 0], R[:, 1, 1], R[:, 1, 2]
    m20, m21, m22 = R[:, 2, 0], R[:, 2, 1], R[:, 2, 2]
    qw = np.sqrt(np.maximum(0.0, 1 + m00 + m11 + m22)) / 2
    qx = np.sqrt(np.maximum(0.0, 1 + m00 - m11 - m22)) / 2
    qy = np.sqrt(np.maximum(0.0, 1 - m00 + m11 - m22)) / 2
    qz = np.sqrt(np.maximum(0.0, 1 - m00 - m11 + m22)) / 2
    q = np.stack([qw, qx, qy, qz], -1)
    # Fix signs relative to the dominant component.
    i = np.argmax(q, axis=-1)
    sx = np.where(i == 0, np.sign(m21 - m12),
                  np.where(i == 1, 1.0, np.where(i == 2, np.sign(m01 + m10),
                                                 np.sign(m02 + m20))))
    sy = np.where(i == 0, np.sign(m02 - m20),
                  np.where(i == 1, np.sign(m01 + m10),
                           np.where(i == 2, 1.0, np.sign(m12 + m21))))
    sz = np.where(i == 0, np.sign(m10 - m01),
                  np.where(i == 1, np.sign(m02 + m20),
                           np.where(i == 2, np.sign(m12 + m21), 1.0)))
    sw = np.where(i == 0, 1.0, np.where(
        i == 1, np.sign(m21 - m12), np.where(i == 2, np.sign(m02 - m20),
                                             np.sign(m10 - m01))))
    s = np.stack([sw, sx, sy, sz], -1)
    s[s == 0] = 1.0
    q = q * s
    return q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), _EPS)


def _merge_pairs(xyz, cov, sh, opac, weight):
    """Moment-matched merge of consecutive pairs.  All inputs [N, ...]; when
    N is odd the last node is carried up unchanged.  Returns parent arrays of
    length ceil(N/2) plus the child_count per parent."""
    n = xyz.shape[0]
    n_pairs = n // 2
    odd = n % 2 == 1

    def pair(a):
        return a[0:2 * n_pairs:2], a[1:2 * n_pairs:2]

    w0, w1 = pair(weight)
    wsum = w0 + w1
    f0 = (w0 / np.maximum(wsum, _EPS))[:, None]
    f1 = (w1 / np.maximum(wsum, _EPS))[:, None]

    x0, x1 = pair(xyz)
    mu = f0 * x0 + f1 * x1
    c0, c1 = pair(cov)
    d0 = x0 - mu
    d1 = x1 - mu
    cv = (f0[..., None] * (c0 + d0[:, :, None] * d0[:, None, :])
          + f1[..., None] * (c1 + d1[:, :, None] * d1[:, None, :]))
    s0, s1 = pair(sh)
    sh_p = f0[:, :, None] * s0 + f1[:, :, None] * s1
    o0, o1 = pair(opac)
    # Mass preservation: o_p · vol_p = Σ o_i · vol_i (clamped to [0,1)).
    vol_p = np.sqrt(np.maximum(np.linalg.det(cv), _EPS))
    mass = w0 + w1                       # weight := o · sqrt(det Σ)
    o_p = np.clip(mass / np.maximum(vol_p, _EPS), 1e-4, 0.9999)

    if odd:
        mu = np.concatenate([mu, xyz[-1:]])
        cv = np.concatenate([cv, cov[-1:]])
        sh_p = np.concatenate([sh_p, sh[-1:]])
        o_p = np.concatenate([o_p, opac[-1:]])
        wsum = np.concatenate([wsum, weight[-1:]])
    child_count = np.full(mu.shape[0], 2, np.int32)
    if odd:
        child_count[-1] = 1
    return mu, cv, sh_p, o_p, wsum, child_count


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def build_hierarchy(params: GaussianParams, active=None,
                    scaffold_rows: int = 0, skybox_rows: int = 0,
                    opacity_activation: str = "sigmoid",
                    device: str | torch.device = DEFAULT_DEVICE) -> Hierarchy:
    """Build the LOD tree over a trained chunk.

    ``params``: chunk model rows (raw).  Leading ``scaffold_rows`` rows are
    the scaffold block — its **first ``skybox_rows``** (per the chunk layout,
    ``models/gaussians.py``) become the hierarchy's skybox *tail*, remaining
    scaffold rows become anchor leaves.  ``active`` masks real rows of a
    capacity-padded model.  ``params`` fields may be tensors on any device
    or numpy arrays; the build runs in numpy on the host and the result
    lands on ``device``.
    """
    dev = resolve_device(device)
    p = GaussianParams(*(_host(x) for x in params))
    if active is not None:
        idx = np.nonzero(_host(active))[0]
    else:
        idx = np.arange(p.xyz.shape[0])

    head = idx[idx < skybox_rows]                 # skybox rows (tail storage)
    body = idx[idx >= skybox_rows]                # tree leaves
    is_scaffold = (body < scaffold_rows)

    xyz = p.xyz[body]
    log_scales = p.log_scales[body]
    quats = p.quats[body]
    sh = np.concatenate([p.features_dc[body], p.features_rest[body]], axis=1)
    raw_op = p.opacity_raw[body][:, 0]
    if opacity_activation == "abs":
        opac = np.abs(raw_op)
    else:
        opac = 1.0 / (1.0 + np.exp(-raw_op))
    scales = np.exp(log_scales)

    order = morton_order(xyz)
    xyz, scales, quats, sh, opac = (xyz[order], scales[order], quats[order],
                                    sh[order], opac[order])
    is_scaffold = is_scaffold[order]
    log_scales = log_scales[order]
    raw_op = raw_op[order]

    n_leaves = xyz.shape[0]
    cov = _covariances(scales, quats)
    weight = opac * np.sqrt(np.maximum(np.linalg.det(cov), _EPS))

    # Level-by-level build.  Per level we store (global node ids).
    levels = [dict(xyz=xyz, cov=cov, sh=sh, opac=opac, weight=weight,
                   quats=quats, scales=scales,
                   ids=np.arange(n_leaves),
                   frozen=is_scaffold.copy())]
    next_id = n_leaves
    parent = np.full(n_leaves, -1, np.int64)
    child_start_list = [np.zeros(n_leaves, np.int64)]
    child_count_list = [np.zeros(n_leaves, np.int64)]
    all_nodes = [dict(xyz=xyz, scales=scales, quats=quats, sh=sh, opac=opac,
                      frozen=is_scaffold.copy())]

    cur = levels[0]
    while cur["xyz"].shape[0] > 1:
        n = cur["xyz"].shape[0]
        mu, cv, sh_p, o_p, w_p, ccount = _merge_pairs(
            cur["xyz"], cur["cov"], cur["sh"], cur["opac"], cur["weight"])
        m = mu.shape[0]
        ids = next_id + np.arange(m)
        next_id += m

        # Parent wiring for the current level's nodes.
        par_of = np.repeat(ids, 2)[:n]
        parent = np.concatenate([parent, np.full(m, -1, np.int64)])
        parent[cur["ids"]] = par_of

        cstart = cur["ids"][0::2]
        child_start_list.append(cstart.astype(np.int64))
        child_count_list.append(ccount.astype(np.int64))

        # Recover scales/quats of merged covariances.
        evals, evecs = np.linalg.eigh(cv)
        evals = np.maximum(evals, 1e-10)
        # eigh may return improper rotations; flip one axis when det < 0.
        det = np.linalg.det(evecs)
        evecs[:, :, 0] *= np.where(det < 0, -1.0, 1.0)[:, None]
        scl = np.sqrt(evals)
        qt = _rotmat_to_quat(evecs)

        frozen_p = cur["frozen"][0::2].copy()
        if n % 2 == 0:
            frozen_p &= cur["frozen"][1::2]
        else:
            frozen_p[:-1] &= cur["frozen"][1::2]

        all_nodes.append(dict(xyz=mu, scales=scl, quats=qt, sh=sh_p,
                              opac=o_p, frozen=frozen_p))
        cur = dict(xyz=mu, cov=cv, sh=sh_p, opac=o_p, weight=w_p, ids=ids,
                   frozen=frozen_p)

    n_nodes = next_id

    def cat(key):
        return np.concatenate([lvl[key] for lvl in all_nodes], axis=0)

    node_xyz = cat("xyz")
    node_scales = cat("scales")
    node_quats = cat("quats")
    node_sh = cat("sh")
    node_opac = np.clip(cat("opac"), 1e-5, 1.0 - 1e-5)
    node_frozen = cat("frozen")

    child_start = np.concatenate(child_start_list)
    child_count = np.concatenate(child_count_list)

    # Subtree AABBs bottom-up: leaves bound their 3σ ellipsoid.
    half = np.zeros((n_nodes, 3), np.float32)
    center = node_xyz.astype(np.float32).copy()
    half[:n_leaves] = 3.0 * node_scales[:n_leaves]
    lo = center - half
    hi = center + half
    base = n_leaves
    level_sizes = [lvl["xyz"].shape[0] for lvl in all_nodes]
    offs = np.cumsum([0] + level_sizes)
    for li in range(1, len(level_sizes)):
        b, e = offs[li], offs[li + 1]
        cs = child_start[b:e]
        cc = child_count[b:e]
        lo0 = lo[cs]
        hi0 = hi[cs]
        has2 = cc == 2
        lo1 = np.where(has2[:, None], lo[np.minimum(cs + 1, n_nodes - 1)],
                       lo0)
        hi1 = np.where(has2[:, None], hi[np.minimum(cs + 1, n_nodes - 1)],
                       hi0)
        lo[b:e] = np.minimum(lo0, lo1)
        hi[b:e] = np.maximum(hi0, hi1)
    box_center = 0.5 * (lo + hi)
    box_half = 0.5 * (hi - lo)
    size = 2.0 * np.max(box_half, axis=1)

    # Append the skybox tail rows (raw params, weight-1 render passthrough).
    sky = GaussianParams(
        xyz=p.xyz[head], features_dc=p.features_dc[head],
        features_rest=p.features_rest[head], log_scales=p.log_scales[head],
        quats=p.quats[head], opacity_raw=p.opacity_raw[head])

    # Output convention: hierarchy rows store *activated* opacity directly —
    # the post-opt model runs with the abs activation, mirroring the
    # reference's create_from_hier switch (``scene/gaussian_model.py:
    # 411-412``).  The skybox tail is converted from the chunk model's raw
    # encoding to match.
    node_raw_op = node_opac
    if opacity_activation == "abs":
        sky_raw_op = np.abs(np.asarray(sky.opacity_raw))
    else:
        sky_raw_op = 1.0 / (1.0 + np.exp(-np.asarray(sky.opacity_raw)))
    def f32(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=dev)

    def i32(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.int32), device=dev)

    hier_params = GaussianParams(
        xyz=f32(np.concatenate([node_xyz, sky.xyz])),
        features_dc=f32(np.concatenate([node_sh[:, :1], sky.features_dc])),
        features_rest=f32(np.concatenate([node_sh[:, 1:],
                                          sky.features_rest])),
        log_scales=f32(np.concatenate(
            [np.log(np.maximum(node_scales, 1e-10)), sky.log_scales])),
        quats=f32(np.concatenate([node_quats, sky.quats])),
        opacity_raw=f32(np.concatenate([node_raw_op[:, None], sky_raw_op])),
    )

    return Hierarchy(
        params=hier_params,
        parent=i32(parent),
        child_start=i32(child_start),
        child_count=i32(child_count),
        box_center=f32(box_center),
        box_half=f32(box_half),
        size=f32(size),
        anchors=torch.as_tensor(np.asarray(node_frozen, bool), device=dev),
        skybox_count=int(head.size),
    )
