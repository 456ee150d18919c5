"""Multi-chunk hierarchy consolidation, mirroring
``street_sparse_3dgs_tpu/hierarchy/merge.py`` (the GaussianHierarchyMerger
equivalent): per-chunk trees are re-rooted under pairwise-merged
super-nodes, indices are remapped by offset, the skybox tail is taken from
the first chunk (chunks share the scaffold skybox), and anchor masks are
concatenated.  The merge runs in numpy on the host with the builder's
``_covariances``, ``_merge_pairs`` and ``_rotmat_to_quat`` — the same
arithmetic as the JAX package, so both give the same arrays — and the
result lands on ``device``.  Super-node children are not index-contiguous;
cut selection is parent-pointer based and never walks child ranges.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..models.gaussians import GaussianParams
from .build import _covariances, _host, _merge_pairs, _rotmat_to_quat
from .structure import Hierarchy


def merge_hierarchies(chunks: list[Hierarchy],
                      device: str | torch.device = DEFAULT_DEVICE
                      ) -> Hierarchy:
    """One hierarchy over ``chunks`` (tensors on any device), on
    ``device``.  A single chunk is moved there unchanged."""
    dev = resolve_device(device)
    if len(chunks) == 1:
        h = chunks[0]
        return Hierarchy(
            params=GaussianParams(*(x.to(dev) for x in h.params)),
            **{k: getattr(h, k).to(dev) for k in Hierarchy._fields[1:-1]},
            skybox_count=h.skybox_count)

    # Strip skybox tails; remember the first chunk's.
    sky = None
    node_params, parents, cstarts, ccounts = [], [], [], []
    centers, halves, sizes, anchors = [], [], [], []
    roots = []
    offset = 0
    for ci, h in enumerate(chunks):
        n = h.n_nodes
        p = GaussianParams(*(_host(x)[:n] for x in h.params))
        if ci == 0 and h.skybox_count > 0:
            sky = GaussianParams(
                *(_host(x)[n:] for x in h.params))
        par = _host(h.parent).copy()
        root_local = int(np.nonzero(par < 0)[0][0])
        roots.append(offset + root_local)
        par = np.where(par >= 0, par + offset, -1)
        node_params.append(p)
        parents.append(par)
        cstarts.append(_host(h.child_start) + offset)
        ccounts.append(_host(h.child_count))
        centers.append(_host(h.box_center))
        halves.append(_host(h.box_half))
        sizes.append(_host(h.size))
        anchors.append(_host(h.anchors))
        offset += n

    params = GaussianParams(*(np.concatenate(leaves, 0)
                              for leaves in zip(*node_params)))
    parent = np.concatenate(parents)
    child_start = np.concatenate(cstarts)
    child_count = np.concatenate(ccounts)
    box_center = np.concatenate(centers)
    box_half = np.concatenate(halves)
    size = np.concatenate(sizes)
    anchor = np.concatenate(anchors)

    # Chain-merge chunk roots pairwise into super-nodes until one root
    # remains (keeps the binary-sibling invariant of the builder).
    cur = list(roots)
    while len(cur) > 1:
        nxt = []
        i = 0
        while i < len(cur):
            if i + 1 < len(cur):
                a, b = cur[i], cur[i + 1]
                xyz = params.xyz[[a, b]]
                scales = np.exp(params.log_scales[[a, b]])
                quats = params.quats[[a, b]]
                sh = np.concatenate([params.features_dc[[a, b]],
                                     params.features_rest[[a, b]]], axis=1)
                opac = np.abs(params.opacity_raw[[a, b], 0])
                cov = _covariances(scales, quats)
                w = opac * np.sqrt(np.maximum(np.linalg.det(cov), 1e-12))
                mu, cv, sh_p, o_p, _, _ = _merge_pairs(xyz, cov, sh, opac, w)
                evals, evecs = np.linalg.eigh(cv)
                evals = np.maximum(evals, 1e-10)
                det = np.linalg.det(evecs)
                evecs[:, :, 0] *= np.where(det < 0, -1.0, 1.0)[:, None]
                new_id = params.xyz.shape[0]
                params = GaussianParams(
                    xyz=np.concatenate([params.xyz, mu]),
                    features_dc=np.concatenate(
                        [params.features_dc, sh_p[:, :1]]),
                    features_rest=np.concatenate(
                        [params.features_rest, sh_p[:, 1:]]),
                    log_scales=np.concatenate(
                        [params.log_scales,
                         np.log(np.sqrt(evals))]),
                    quats=np.concatenate([params.quats,
                                          _rotmat_to_quat(evecs)]),
                    opacity_raw=np.concatenate(
                        [params.opacity_raw,
                         np.clip(o_p, 1e-5, 1 - 1e-5)[:, None]]),
                )
                parent = np.concatenate([parent, [-1]])
                parent[a] = new_id
                parent[b] = new_id
                # Sibling contiguity does not hold for super-nodes; the cut
                # never reads child_start of interior nodes (selection is
                # parent-pointer based), so store the pair loosely.
                child_start = np.concatenate([child_start, [a]])
                child_count = np.concatenate([child_count, [2]])
                lo = np.minimum(box_center[a] - box_half[a],
                                box_center[b] - box_half[b])
                hi = np.maximum(box_center[a] + box_half[a],
                                box_center[b] + box_half[b])
                box_center = np.concatenate([box_center, [(lo + hi) / 2]])
                box_half = np.concatenate([box_half, [(hi - lo) / 2]])
                size = np.concatenate([size, [np.max(hi - lo)]])
                anchor = np.concatenate([anchor, [False]])
                nxt.append(new_id)
                i += 2
            else:
                nxt.append(cur[i])
                i += 1
        cur = nxt

    n_nodes = params.xyz.shape[0]
    if sky is not None:
        params = GaussianParams(*(np.concatenate([a, b], 0)
                                  for a, b in zip(params, sky)))
        skybox_count = sky.xyz.shape[0]
    else:
        skybox_count = 0

    def t(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x, dtype), device=dev)

    return Hierarchy(
        params=GaussianParams(*(t(x, np.float32) for x in params)),
        parent=t(parent, np.int32),
        child_start=t(child_start, np.int32),
        child_count=t(child_count, np.int32),
        box_center=t(box_center, np.float32),
        box_half=t(box_half, np.float32),
        size=t(size, np.float32),
        anchors=t(anchor, bool),
        skybox_count=skybox_count,
    )
