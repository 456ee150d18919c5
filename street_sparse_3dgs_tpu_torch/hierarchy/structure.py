"""LOD hierarchy: flat node arrays and the view-dependent cut, mirroring
``street_sparse_3dgs_tpu/hierarchy/structure.py``.

A node is in the cut iff its own projected size (world size over distance
to its box) is under the limit, or it is a leaf, while its parent's is not
— a closed-form selection over all nodes.  Rows [0, n_nodes) of ``params``
are tree nodes; rows [n_nodes, n_nodes + skybox_count) are the skybox tail.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.gaussians import GaussianParams
from ..profiling import span


class Hierarchy(NamedTuple):
    params: GaussianParams        # [n_nodes + skybox] raw (pre-activation)
    parent: torch.Tensor          # [n_nodes] int32, -1 at root
    child_start: torch.Tensor     # [n_nodes] int32
    child_count: torch.Tensor     # [n_nodes] int32 (0 => leaf)
    box_center: torch.Tensor      # [n_nodes, 3]
    box_half: torch.Tensor        # [n_nodes, 3]
    size: torch.Tensor            # [n_nodes] world-space extent (cut metric)
    anchors: torch.Tensor         # [n_nodes] bool
    skybox_count: int

    @property
    def n_nodes(self) -> int:
        return self.parent.shape[0]

    @property
    def n_rows(self) -> int:
        return self.params.xyz.shape[0]


class Cut(NamedTuple):
    """A view-dependent cut in mask form: ``selected`` nodes render, each
    lerped with its parent by ``weights`` (w·node + (1-w)·parent)."""

    selected: torch.Tensor        # [n_nodes] bool
    weights: torch.Tensor         # [n_nodes] float in (0, 1]
    parent: torch.Tensor          # [n_nodes] int32 (self-index at root)
    num_siblings: torch.Tensor    # [n_nodes] int32


def pixel_limit(tau: float, tan_fovx: float, width: int) -> float:
    """Target granularity τ in pixels -> world size-over-distance limit."""
    return (2.0 * (tau + 0.5)) * tan_fovx / (0.5 * width)


def _norm3(x: torch.Tensor) -> torch.Tensor:
    # Summed in the same order as the JAX reference's norm over 3 entries.
    return torch.sqrt((x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1])
                      + x[..., 2] * x[..., 2])


def _cut_metric(h: Hierarchy, campos: torch.Tensor):
    """(metric, parent_metric, is_leaf): the inputs of the cut predicate,
    shared by ``select_cut`` and ``budget_limit``."""
    eps = 1e-6
    d_center = _norm3(h.box_center - campos[None, :])
    d = torch.clamp(d_center - _norm3(h.box_half), min=eps)
    metric = h.size / d
    parent = torch.clamp(h.parent, min=0).to(torch.int64)
    parent_metric = torch.where(h.parent < 0,
                                torch.full_like(metric, float("inf")),
                                metric[parent])
    return metric, parent_metric, h.child_count == 0


def budget_limit(h: Hierarchy, campos: torch.Tensor, budget: int,
                 iters: int = 20) -> torch.Tensor:
    """Smallest size-over-distance limit whose cut has at most ``budget``
    nodes, by bisection (the cut size is non-increasing in the limit)."""
    metric, parent_metric, is_leaf = _cut_metric(h, campos)

    def count(lim):
        return torch.sum(((metric <= lim) | is_leaf) & (parent_metric > lim))

    finite = torch.where(torch.isfinite(metric), metric,
                         torch.zeros_like(metric))
    lo = torch.zeros((), dtype=torch.float32, device=metric.device)
    hi = torch.clamp(torch.max(finite), min=1.0) * 2.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        fits = count(mid) <= budget
        lo, hi = torch.where(fits, lo, mid), torch.where(fits, mid, hi)
    return hi


def select_cut(h: Hierarchy, campos: torch.Tensor, limit) -> Cut:
    """Vectorized cut selection and interpolation weights: selected iff
    (m_i <= limit or leaf) and m_parent > limit; weight
    t = clamp((m_p − limit)/(m_p − m_i), 0, 1)."""
    with span("hierarchy.cut"):
        eps = 1e-6
        metric, parent_metric, is_leaf = _cut_metric(h, campos)
        parent = torch.clamp(h.parent, min=0).to(torch.int64)
        is_root = h.parent < 0

        small_enough = (metric <= limit) | is_leaf
        selected = small_enough & (parent_metric > limit)

        t = (parent_metric - limit) / torch.clamp(parent_metric - metric,
                                                  min=eps)
        t = torch.where(torch.isinf(parent_metric), torch.ones_like(t), t)
        weights = torch.clamp(t, 0.0, 1.0)
        weights = torch.where(selected, torch.clamp(weights, min=eps),
                              torch.ones_like(weights))

        node_ids = torch.arange(h.n_nodes, device=h.parent.device,
                                dtype=h.parent.dtype)
        parent_self = torch.where(is_root, node_ids, h.parent)
        num_siblings = torch.where(is_root, torch.ones_like(h.child_count),
                                   h.child_count[parent])
        return Cut(selected=selected, weights=weights,
                   parent=parent_self.to(torch.int32),
                   num_siblings=num_siblings.to(torch.int32))
