"""Tile-sharded rendering: one image's 16x16 tiles split over the ranks of
the mesh's ``tile`` axis, mirroring ``street_sparse_3dgs_tpu/parallel/
tiles.py``.

The execution model: a rank is a process with one explicit
``torch.device`` (``parallel/mesh.py``); the collectives go through
``parallel/collectives.py``.  Projection and binning run replicated on
every rank (O(N) and O(N·D log) work, small next to the blend); each rank
blends a contiguous slab of the tile range, and ``all_gather_slabs``
assembles the image on every rank.

- Padded path: the tile range is padded to a multiple of the ranks; rank r
  packs the rows of its slab of the tile table and blends them with K1 at
  ``tile0 = r · t_local``.
- Exact path: ``bin_gaussians(..., exact_shards=n)`` places every rank's
  windows in a segment of its own; every rank packs the whole window
  layout and runs K3 over its own real tiles through ``order`` (K4, the
  backward, over the same tiles).  The whole layout, not the rank's
  segment alone, because the counts-mode backward segments the slot->row
  reduction by binning's ``seg_pos``, a prefix over every window's slots;
  and because K3 takes a tile's pixel origin from its index in the layout.
  The rows of the other ranks' tiles are zero and their grads are never
  formed (``cuda_blend._BlendExact``).

Grads: the image's cotangent is replicated, ``all_gather_slabs`` hands
each rank its slab's part, so each rank's slot grads, ``slot_grads_to_rows``
and the replicated projection's backward give PARTIAL grads of the inputs;
``sum_grads`` sums them over the tile axis.  Anything applied to the
assembled image (the exposure affine, the loss) is replicated and is not
summed.

The binning settings (``ops.rasterize.bin_kwargs``, ``attr_dtype``) and the
image assembly from the packed rows (``ops.cuda_blend.image_outputs``) are
the serial path's, so binning takes ``dup_overscan`` and ``dup_tails``
from the config as the serial ``rasterize`` does (JAX's tile-sharded path
leaves them at their defaults; the two agree on a default config).
"""

from __future__ import annotations

import torch

from ..core.camera import CameraParams
from ..ops.binning import bin_gaussians
from ..ops import cuda_blend
from ..ops.cuda_blend import image_outputs
from ..ops.preprocess import project_gaussians
from ..ops.rasterize import RasterConfig, attr_dtype, bin_kwargs
from .collectives import all_gather_slabs, sum_grads
from .mesh import Mesh


def padded_last_v(bins, t_pad: int) -> torch.Tensor:
    """The last window of every tile of the shard-padded range [t_pad]
    int32 (the padding tiles own one empty window each), from the window
    table ``t_of_v`` (``tp.py:210-217``)."""
    t_of_v = bins.t_of_v.to(torch.int64)
    nv = t_of_v.shape[0]
    idx = torch.where(t_of_v < t_pad, t_of_v, torch.full_like(t_of_v, t_pad))
    last = torch.zeros(t_pad + 1, dtype=torch.int64, device=t_of_v.device)
    last.scatter_reduce_(0, idx, torch.arange(nv, device=t_of_v.device),
                         "amax")
    return last[:t_pad].to(torch.int32)


def pad_tiles(x: torch.Tensor, rows: int, value=0) -> torch.Tensor:
    """``x`` [T, ...] padded with ``value`` to ``rows`` rows."""
    extra = rows - x.shape[0]
    if extra == 0:
        return x
    return torch.cat([x, x.new_full((extra,) + tuple(x.shape[1:]), value)])


def rasterize_tile_sharded(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    sh_coeffs: torch.Tensor,
    camera: CameraParams,
    sh_degree: int,
    bg: torch.Tensor,
    mesh: Mesh,
    config: RasterConfig = RasterConfig(method="pallas"),
    active_mask: torch.Tensor | None = None,
    mean2d_residual: torch.Tensor | None = None,
):
    """Differentiable render with the tiles split over ``mesh``'s tile
    axis; every rank passes the same (replicated) rows and gets the whole
    image.  Same outputs as ``ops.rasterize.rasterize`` (``vis_overflow``
    included).  The grads of the rows, ``bg`` and ``mean2d_residual`` are
    summed over the tile axis in the backward, so every rank holds the
    whole grad."""
    group = mesh.group("tile")
    n, r = mesh.size("tile"), mesh.index("tile")
    (means3d, scales, quats, opacities, sh_coeffs, bg,
     mean2d_residual) = sum_grads(group, means3d, scales, quats, opacities,
                                  sh_coeffs, bg, mean2d_residual)
    proj = project_gaussians(means3d, scales, quats, opacities, sh_coeffs,
                             camera, sh_degree, 1.0, active_mask)
    if mean2d_residual is not None:
        proj = proj._replace(mean2d=proj.mean2d + mean2d_residual)
    h, w = camera.height, camera.width
    bg2 = bg.reshape(1, 3).to(torch.float32).contiguous()
    exact = bool(config.exact_extra)
    extra = -(-config.exact_extra // n) * n if exact else 0
    bins = bin_gaussians(proj, h, w, config.max_dup, config.tile_capacity,
                         **bin_kwargs(config, extra, n))
    tiles_x, tiles_y = bins.tiles_x, bins.tiles_y
    t_pad = -(-tiles_x * tiles_y // n) * n
    t_local = t_pad // n
    lo, hi = r * t_local, (r + 1) * t_local
    if exact:
        attrs = cuda_blend.pack_gather_attrs(
            bins.gather, proj.mean2d, proj.conic, proj.color, proj.opacity,
            proj.inv_depth, dtype=attr_dtype(config), order=bins.order,
            rank=bins.rank, grad_sort=config.grad_sort, seg_pos=bins.seg_pos,
            pair_major=True)                               # [T_v, K, 10]
        order = torch.arange(lo, hi, dtype=torch.int32, device=attrs.device)
        out = cuda_blend.blend_exact(attrs, bins.vcounts, bins.wt,
                                     padded_last_v(bins, t_pad), bg2,
                                     tiles_x, order=order)[lo:hi]
    else:
        sentinel = bins.order.shape[0]
        gather = pad_tiles(bins.gather, t_pad, sentinel)[lo:hi]
        counts = pad_tiles(bins.counts.to(torch.int32), t_pad)[lo:hi]
        attrs = cuda_blend.pack_gather_attrs(
            gather, proj.mean2d, proj.conic, proj.color, proj.opacity,
            proj.inv_depth, dtype=attr_dtype(config), order=bins.order,
            rank=bins.rank, grad_sort=config.grad_sort)  # [t_local, 10, K]
        out = cuda_blend.blend_padded(attrs, counts.contiguous(), bg2,
                                      tiles_x, tile0=lo)
    full = all_gather_slabs(out, group)                  # [t_pad, 8, 256]
    res = image_outputs(full, tiles_x, tiles_y, h, w)
    res.update(radii=proj.radius, visibility=proj.valid,
               dup_overflow=bins.dup_overflow,
               tile_overflow=bins.tile_overflow,
               vis_overflow=bins.vis_overflow)
    return res

