"""Self-sizing of the exact (virtual-tile) rasterizer's budgets, mirroring
``street_sparse_3dgs_tpu/ops/autosize.py``: the emission and window knobs
(``max_dup``, ``dup_overscan``, ``dup_tails``, ``exact_extra``) are derived
from binning statistics measured over a sample of views, with margin, so a
scene trains with no hand-set exact knob.  Drift during training is caught
by the train loop's budget growth and its re-autosize at capacity growths.

Two measurements per sampled view:

1. **Emission ladder**: the surviving-tile counts (``kept``) of the
   ``probe_rows`` rows of largest rect coverage, counted exactly over up to
   ``probe_scan`` rect positions; every other row is bounded by its
   coverage (kept <= coverage).  ``derive_ladder`` (host numpy, as in JAX)
   turns the merged profile into the tail-bucket ladder.
2. **Window budget**: a stats-only ``bin_gaussians`` per view (K5 builds
   its table on the card) with the derived ladder; the view needs
   ``sum(max(ceil(count / K), 1)) - T`` extra windows.

The probed rows are those of largest coverage, ties broken by the lower
row index as ``jax.lax.top_k`` breaks them (a stable descending sort), so
the two packages probe the same rows.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .binning import _tile_qmin, bin_gaussians, num_tiles, tile_rect
from .oracle import ALPHA_MIN
from .preprocess import Projected, project_gaussians


class ExactKnobs(NamedTuple):
    max_dup: int
    dup_overscan: int
    dup_tails: tuple            # ((budget, width), ...)
    exact_extra: int
    # Measured expectations at the sampled views (diagnostics):
    expected_dup_overflow: int  # pair slots past the scan window (worst view)
    expected_extras: int        # windows actually needed (worst view)


def _coverage_pass(proj: Projected, tiles_x: int,
                   tiles_y: int) -> torch.Tensor:
    """[N] int32 rect tile coverage per row (upper bound on surviving
    tiles)."""
    x0, y0, x1, y1 = tile_rect(proj.mean2d, proj.radius, tiles_x, tiles_y)
    cov = torch.where(proj.valid, (x1 - x0) * (y1 - y0),
                      torch.zeros_like(x0))
    return cov.to(torch.int32)


def _kept_probe(proj: Projected, rows: torch.Tensor, scan: int,
                tiles_x: int, tiles_y: int) -> torch.Tensor:
    """[R] int32 exact surviving-tile count of ``rows`` (the ellipse
    culling of ``bin_gaussians``), evaluating up to ``scan`` rect
    positions."""
    mean2d = proj.mean2d[rows]
    conic = proj.conic[rows]
    opacity = proj.opacity[rows]
    valid = proj.valid[rows]
    x0, y0, x1, y1 = tile_rect(mean2d, proj.radius[rows], tiles_x, tiles_y)
    zero = torch.zeros_like(x0)
    nx = torch.where(valid, x1 - x0, zero)
    ny = torch.where(valid, y1 - y0, zero)
    coverage = nx * ny
    slots = torch.arange(scan, dtype=torch.int32, device=rows.device)
    nx_safe = torch.clamp(nx, min=1)
    inv_nx = 1.0 / nx_safe.to(torch.float32)
    sy = torch.floor((slots[None, :].to(torch.float32) + 0.5)
                     * inv_nx[:, None]).to(torch.int32)
    sx = slots[None, :] - sy * nx_safe[:, None]
    tile_x = x0[:, None] + sx
    tile_y = y0[:, None] + sy
    in_range = slots[None, :] < torch.clamp(coverage, max=scan)[:, None]
    qmin = _tile_qmin(mean2d, conic, tile_x, tile_y)
    log_amin = torch.log(torch.tensor(ALPHA_MIN * (1.0 - 1e-3),
                                      dtype=torch.float32,
                                      device=rows.device))
    qcap = 2.0 * (torch.where(opacity > 0.0,
                              torch.log(torch.clamp(opacity, min=1e-30)),
                              torch.full_like(opacity, -math.inf))
                  - log_amin)
    keep = in_range & (qmin <= qcap[:, None])
    return torch.sum(keep, dim=1, dtype=torch.int32)


def _ceil_pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def derive_ladder(kept_probe: np.ndarray, cov_all_sorted: np.ndarray,
                  max_dup: int, scan_cap: int,
                  margin: float) -> tuple[int, tuple]:
    """Tail-bucket ladder from the probed kept counts.

    ``cov_all_sorted`` — descending coverage of ALL valid rows;
    ``kept_probe`` — exact kept of the top ``len(kept_probe)`` rows (rows
    off the probe are bounded by coverage: kept <= coverage).  Returns
    ``(dup_overscan, dup_tails)`` with total positions <= ``scan_cap``."""
    kept_sorted = np.sort(kept_probe)[::-1]
    n_probe = len(kept_probe)
    off_probe = cov_all_sorted[n_probe:]

    def cnt_gt(s: int) -> int:
        exact = int(np.searchsorted(-kept_sorted, -s, side="left"))
        # Rows off the probe: coverage bound (conservative).
        bound = int(np.searchsorted(-off_probe, -s, side="left"))
        return exact + bound

    kmax = int(kept_sorted[0]) if n_probe else 0
    tails = []
    s = max_dup
    while s < min(kmax, scan_cap) and len(tails) < 4:
        c = cnt_gt(s)
        if c == 0:
            break
        budget = _ceil_pow2(int(math.ceil(c * margin)))
        # Advance to the kept value at a geometrically-decayed rank so each
        # bucket's budget drops ~16x (the measured street ladders' shape).
        target = max(1, c // 16)
        if target <= n_probe:
            s_next = int(kept_sorted[target - 1])
        else:
            s_next = int(off_probe[min(target - n_probe, len(off_probe)) - 1]
                         ) if len(off_probe) else kmax
        width = max(4, s_next - s)
        width = min(width, scan_cap - s)
        if width <= 0:
            break
        tails.append((budget, width))
        s += width
    # Last bucket absorbs the remaining scan window if the max kept still
    # is not covered (bin_gaussians clamps widths to the scan anyway).
    if s < min(kmax, scan_cap) and tails:
        b, wd = tails[-1]
        tails[-1] = (b, wd + (min(kmax, scan_cap) - s))
        s = min(kmax, scan_cap)
    overscan = max(1, -(-s // max_dup))
    return overscan, tuple(tails)


def autosize_raster(means3d, scales, quats, opacities, sh_coeffs, cameras,
                    sh_degree: int, height: int, width: int,
                    tile_capacity: int, *, max_dup: int = 2,
                    scan_cap: int = 64, probe_rows: int = 16384,
                    probe_scan: int = 1024, margin: float = 1.25,
                    shards: int = 1, active_mask=None,
                    max_views: int = 8, scan_cap_max: int | None = None,
                    dup_tol: float = 1e-3) -> ExactKnobs:
    """Derive exact-mode knobs from up to ``max_views`` sampled cameras
    (same arguments and result as the JAX function).

    The knobs bind every sampled view with no window overflow (and
    ``expected_dup_overflow`` emission overflow at most) at
    ``tile_capacity``-wide windows, with ``margin`` headroom; ``exact_extra``
    is a multiple of ``128 * shards``.  ``max_dup == 0`` sizes the base
    emission width from the median positive rect coverage (a power of two
    in [2, 16]).  The scan window doubles from ``scan_cap`` while the
    emission overflow exceeds ``dup_tol`` of the binned pairs, up to
    ``scan_cap_max``."""
    tiles_x, tiles_y = num_tiles(height, width)
    t_total = tiles_x * tiles_y
    cams = cameras[:max_views]
    probe_rows = min(probe_rows, means3d.shape[0])

    with torch.no_grad():
        ladder_inputs = []
        for cam in cams:
            proj = project_gaussians(means3d, scales, quats, opacities,
                                     sh_coeffs, cam, sh_degree, 1.0,
                                     active_mask)
            proj = Projected(*(x.detach() for x in proj))
            cov = _coverage_pass(proj, tiles_x, tiles_y)
            rows = torch.sort(cov, descending=True,
                              stable=True).indices[:probe_rows]
            kept = _kept_probe(proj, rows, probe_scan, tiles_x, tiles_y)
            cov_np = cov.cpu().numpy()
            cov_sorted = np.sort(cov_np[cov_np > 0])[::-1]
            ladder_inputs.append((kept.cpu().numpy(), cov_sorted, proj))

        # One ladder must cover EVERY view: the elementwise max of the
        # sorted profiles.
        kept_envelope = np.stack([np.sort(k)[::-1]
                                  for k, _, _ in ladder_inputs]).max(axis=0)
        cov_len = max(len(c) for _, c, _ in ladder_inputs)
        cov_stack = np.zeros((len(ladder_inputs), cov_len), np.int64)
        for i, (_, c, _) in enumerate(ladder_inputs):
            cov_stack[i, :len(c)] = c
        cov_envelope = cov_stack.max(axis=0)
        if max_dup == 0:
            pos = cov_envelope[cov_envelope > 0]
            p50 = int(np.median(pos)) if len(pos) else 2
            max_dup = min(16, max(2, _ceil_pow2(p50)))

        if scan_cap_max is None:
            scan_cap_max = scan_cap
        while True:
            overscan, tails = derive_ladder(kept_envelope, cov_envelope,
                                            max_dup, scan_cap, margin)
            extras_worst = dup_of_worst = 0
            pairs_worst = 1
            for _, _, proj in ladder_inputs:
                bins = bin_gaussians(proj, height, width, max_dup,
                                     tile_capacity, dup_tails=tails,
                                     dup_overscan=overscan)
                windows = torch.clamp(-torch.div(-bins.counts, tile_capacity,
                                                 rounding_mode="floor"),
                                      min=1)
                extras_worst = max(extras_worst,
                                   int(windows.sum()) - t_total)
                dup_of_worst = max(dup_of_worst, int(bins.dup_overflow))
                pairs_worst = max(pairs_worst, int(bins.counts.sum()))
            if dup_of_worst <= dup_tol * pairs_worst or \
                    scan_cap >= scan_cap_max:
                break
            scan_cap = min(scan_cap * 2, scan_cap_max)

    unit = 128 * shards
    exact_extra = -(-max(int(math.ceil(extras_worst * margin)), unit)
                    // unit) * unit
    return ExactKnobs(max_dup=max_dup, dup_overscan=overscan,
                      dup_tails=tails, exact_extra=exact_extra,
                      expected_dup_overflow=dup_of_worst,
                      expected_extras=extras_worst)
