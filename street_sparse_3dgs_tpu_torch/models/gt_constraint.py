"""Ground-truth point-cloud densification constraint, mirroring
``street_sparse_3dgs_tpu/models/gt_constraint.py``: at every densify round,
active rows inside the GT cloud's x/y bounds with no GT point within the
threshold are pruned (reference ``scene/gaussian_model.py:796-962``).

The index is a voxel hash built once on the host (``build_index``, numpy,
as in JAX; cell size = threshold, so any neighbour within the threshold
lies in the 3x3x3 cell neighbourhood) and queried on the tensors' device
with a fixed per-cell capacity.  Only "is any GT point within r" is asked:
a capped cell or a hash collision can only keep a row alive, never prune
it wrongly.  Both sides hash with ``core.knn.cell_key`` (the 64-bit hash
wrapped to 32 bits), so the host build and the device query agree with
each other and with JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.knn import cell_key
from ..device import DEFAULT_DEVICE, resolve_device


class GtIndex(NamedTuple):
    """Voxel-hash index over the GT cloud, tensors on one device."""

    points: torch.Tensor        # [M, 3] cell-sorted GT points
    cell_keys: torch.Tensor     # [C] sorted unique (hashed) cell keys, int32
    cell_start: torch.Tensor    # [C] int32 start offset into points
    cell_count: torch.Tensor    # [C] int32 points per cell (uncapped)
    cell_size: float            # == constraint threshold
    bounds: torch.Tensor        # [4]: x_min, x_max, y_min, y_max
    cap_overflow: int           # points beyond the per-cell cap (diagnostic)
    max_per_cell: int


def build_index(gt_points: np.ndarray, threshold: float,
                max_per_cell: int = 64,
                device: str | torch.device = DEFAULT_DEVICE) -> GtIndex:
    """Host-side one-shot build over ``gt_points`` [M, 3] (numpy), the
    tensors placed on ``device``."""
    dev = resolve_device(device)
    pts = np.asarray(gt_points, np.float32)
    cells = np.floor(pts / threshold).astype(np.int64)
    keys = cell_key(torch.from_numpy(cells)).numpy()
    order = np.argsort(keys, kind="stable")
    pts_sorted = pts[order]
    uniq, start, count = np.unique(keys[order], return_index=True,
                                   return_counts=True)
    overflow = int(np.maximum(count - max_per_cell, 0).sum())
    bounds = np.array([pts[:, 0].min(), pts[:, 0].max(),
                       pts[:, 1].min(), pts[:, 1].max()], np.float32)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev)

    return GtIndex(points=t(pts_sorted), cell_keys=t(uniq),
                   cell_start=t(start.astype(np.int32)),
                   cell_count=t(count.astype(np.int32)),
                   cell_size=float(threshold), bounds=t(bounds),
                   cap_overflow=overflow, max_per_cell=int(max_per_cell))


_OFFSETS = [(ox, oy, oz) for ox in (-1, 0, 1) for oy in (-1, 0, 1)
            for oz in (-1, 0, 1)]


def _query_chunk(index: GtIndex, xyz: torch.Tensor) -> torch.Tensor:
    """[Q, 3] -> [Q] bool: True when some GT point is within cell_size."""
    dev = xyz.device
    # A divisor tensor on the device: a Python scalar divisor is applied as
    # a reciprocal product on CUDA, which can round a point on a cell edge
    # into the neighbouring cell.
    cs = torch.tensor(index.cell_size, dtype=torch.float32, device=dev)
    r2 = torch.tensor(index.cell_size ** 2, dtype=torch.float32, device=dev)
    base = torch.floor(xyz / cs).to(torch.int32).to(torch.int64)
    m = index.points.shape[0]
    cap = index.max_per_cell
    slot = torch.arange(cap, device=dev)[None, :]                # [1, cap]
    near = torch.zeros(xyz.shape[0], dtype=torch.bool, device=dev)
    for off in _OFFSETS:
        key = cell_key(base + torch.tensor(off, device=dev))
        pos = torch.searchsorted(index.cell_keys, key)
        pos_c = torch.clamp(pos, max=index.cell_keys.shape[0] - 1)
        hit = index.cell_keys[pos_c] == key
        count = torch.clamp(index.cell_count[pos_c], max=cap)
        idx = torch.clamp(index.cell_start[pos_c].to(torch.int64)[:, None]
                          + slot, max=m - 1)
        d2 = torch.sum((index.points[idx] - xyz[:, None, :]) ** 2, dim=-1)
        valid = hit[:, None] & (slot < count[:, None])
        near = near | torch.any(valid & (d2 <= r2), dim=1)
    return near


def too_far_mask(index: GtIndex, xyz: torch.Tensor, active: torch.Tensor,
                 chunk: int = 8192) -> torch.Tensor:
    """[C] bool: active rows inside the GT x/y bounds with no GT point
    within the threshold (the ``compare_points_to_gt`` prune criterion),
    queried ``chunk`` rows at a time."""
    with torch.no_grad():
        xyz = xyz.detach()
        near = torch.cat([_query_chunk(index, xyz[s:s + chunk])
                          for s in range(0, xyz.shape[0], chunk)])
        b = index.bounds
        in_bounds = ((xyz[:, 0] >= b[0]) & (xyz[:, 0] <= b[1])
                     & (xyz[:, 1] >= b[2]) & (xyz[:, 1] <= b[3]))
        return active & in_bounds & ~near
