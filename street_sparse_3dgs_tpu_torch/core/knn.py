"""Mean squared distance to the 3 nearest neighbours (the reference's
``distCUDA2``, used once at initialisation), mirroring
``street_sparse_3dgs_tpu/core/knn.py``: an exact blocked search up to
``EXACT_KNN_MAX`` points and a voxel-hash approximation above."""

from __future__ import annotations

import numpy as np
import torch

EXACT_KNN_MAX = 200_000


def knn_sq_dists(points: torch.Tensor, k: int = 3, query_block: int = 4096,
                 point_block: int = 16384) -> torch.Tensor:
    """[N, 3] -> [N, k] squared distances to the k nearest OTHER points.
    Distances through ``|q|^2 - 2 q.p + |p|^2`` (clamped at 0) as the JAX
    function does, the dot product as three f32 products; the running
    smallest k+1 per query block are merged with ``topk`` and the closest
    (the point itself) is dropped."""
    pts = points.to(torch.float32)
    n = pts.shape[0]
    norm2 = torch.sum(pts * pts, dim=-1)
    out = []
    for q0 in range(0, n, query_block):
        qb = pts[q0:q0 + query_block]
        best = torch.full((qb.shape[0], k + 1), float("inf"),
                          device=pts.device)
        for p0 in range(0, n, point_block):
            pb = pts[p0:p0 + point_block]
            dot = (qb[:, None, 0] * pb[None, :, 0]
                   + qb[:, None, 1] * pb[None, :, 1]
                   + qb[:, None, 2] * pb[None, :, 2])
            d2 = torch.clamp(norm2[q0:q0 + query_block, None] - 2.0 * dot
                             + norm2[None, p0:p0 + point_block], min=0.0)
            merged = torch.cat([best, d2], dim=1)
            best = torch.topk(merged, k + 1, dim=1, largest=False).values
        out.append(best[:, 1:])
    return torch.cat(out)


def mean_sq_dist_to_3nn(points: torch.Tensor) -> torch.Tensor:
    """distCUDA2 equivalent: [N, 3] -> [N] mean squared distance to 3 NN."""
    return torch.mean(knn_sq_dists(points, k=3), dim=-1)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap-around."""
    return (((x + 2 ** 31) % 2 ** 32) - 2 ** 31).to(torch.int32)


_PRIMES = (73856093, 19349669, 83492791)


def cell_key(cell: torch.Tensor) -> torch.Tensor:
    """[N, 3] integer cells -> int32 spatial hash: the 64-bit XOR of the
    coordinates times three primes, wrapped to 32 bits (the JAX package's
    int32 wrap-around multiply and its host-side 64->32 truncation)."""
    c = cell.to(torch.int64)
    return _wrap_i32((c[:, 0] * _PRIMES[0]) ^ (c[:, 1] * _PRIMES[1])
                     ^ (c[:, 2] * _PRIMES[2]))


def grid_mean_sq_dist_to_3nn(points: torch.Tensor,
                             cell_size: float | None = None,
                             max_per_cell: int = 32,
                             query_chunk: int = 8192) -> torch.Tensor:
    """[N, 3] -> [N] approximate mean squared 3-NN distance: the 3x3x3
    voxel neighbourhood of each point at a cell size tied to the mean
    spacing, at most ``max_per_cell`` candidates per cell; a point with
    fewer than three neighbours there falls back to cell_size^2."""
    pts = points.to(torch.float32)
    dev = pts.device
    n = pts.shape[0]
    if cell_size is None:
        p_np = pts.detach().cpu().numpy()
        lo, hi = p_np.min(0), p_np.max(0)
        vol = float(np.prod(np.maximum(hi - lo, 1e-6)))
        cell_size = 2.0 * (vol / max(n, 1)) ** (1.0 / 3.0)
    keys = cell_key(torch.floor(pts / cell_size))
    order = torch.sort(keys, stable=True).indices
    pts_sorted = pts[order]
    uniq, count = torch.unique_consecutive(keys[order], return_counts=True)
    start = torch.cumsum(count, 0) - count
    cap = max_per_cell
    fallback = torch.tensor(cell_size * cell_size, dtype=torch.float32,
                            device=dev)
    slot = torch.arange(cap, device=dev)[None, :]
    offsets = torch.tensor([[ox, oy, oz] for ox in (-1, 0, 1)
                            for oy in (-1, 0, 1) for oz in (-1, 0, 1)],
                           device=dev)
    out = []
    for q0 in range(0, n, query_chunk):
        xb = pts[q0:q0 + query_chunk]
        base = torch.floor(xb / cell_size).to(torch.int64)
        best = torch.full((xb.shape[0], 4), float("inf"), device=dev)
        for off in offsets:
            key = cell_key(base + off)
            pos = torch.clamp(torch.searchsorted(uniq, key),
                              max=uniq.shape[0] - 1)
            hit = uniq[pos] == key
            ct = torch.clamp(count[pos], max=cap)
            idx = torch.clamp(start[pos][:, None] + slot, max=n - 1)
            d2 = torch.sum((pts_sorted[idx] - xb[:, None, :]) ** 2, dim=-1)
            d2 = torch.where(hit[:, None] & (slot < ct[:, None]), d2,
                             torch.full_like(d2, float("inf")))
            best = torch.topk(torch.cat([best, d2], dim=1), 4, dim=1,
                              largest=False).values
        three = best[:, 1:4]
        out.append(torch.mean(torch.where(torch.isfinite(three), three,
                                          fallback), dim=1))
    return torch.cat(out)


def mean_sq_dist_to_3nn_auto(points: torch.Tensor) -> torch.Tensor:
    """distCUDA2 equivalent with the exact/grid switch at
    ``EXACT_KNN_MAX`` points."""
    if points.shape[0] <= EXACT_KNN_MAX:
        return mean_sq_dist_to_3nn(points)
    return grid_mean_sq_dist_to_3nn(points)
