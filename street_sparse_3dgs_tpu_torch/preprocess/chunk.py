"""Scene chunking — the ``preprocess/ss_make_chunk.py`` /
``generate_chunks.py`` equivalents.

Reference semantics (``ss_make_chunk.py:441-660``):
  - a regular ``chunk_size`` (default 100 m) x/y grid over the camera bbox
    (z unbounded); border chunks absorb outside points;
  - camera selection per chunk: inside → always; within 2× extents → needs
    >20 visible chunk points; farther → random with probability
    ``n_pts/len(points) / 0.5`` when ``add_far_cams``;
  - ``max_n_cams`` random removal / ``min_n_cams`` chunk rejection;
  - per-image 2D-3D matches filtered to points inside the chunk box;
  - ``center.txt`` / ``extent.txt`` stage artifacts;
  - LiDAR tiles overlapping the chunk voxel-downsampled to
    ``lidar_downsample_density`` pts/m³ and merged into the chunk's
    points3D with fresh ids (``:592-630``);
  - depth-only cameras inside the chunk copied into ``images_depths.bin``
    with temporal-gap filling (consecutive recording positions < 10 m apart,
    ``:324-439``).

LiDAR input: ``.laz``/``.las`` tiles (self-contained native LASzip codec,
``preprocess/laz.py`` — no laspy needed) plus ``.ply``/``.npy``/``.npz``.
"""

from __future__ import annotations

import dataclasses
import random
from pathlib import Path

import numpy as np

from ..data import colmap
from ..data.ply import fetch_point_cloud, store_point_cloud


@dataclasses.dataclass
class ChunkConfig:
    chunk_size: float = 100.0
    min_n_cams: int = 5          # fork default (upstream: 100)
    max_n_cams: int = 1500
    add_far_cams: bool = True
    lidar_initialisation: bool = False
    lidar_downsample_density: float = 2000.0   # points per m^3
    seed: int = 0


def camera_centers(images: dict[int, colmap.ColmapImage]) -> np.ndarray:
    return np.stack([
        -colmap.qvec2rotmat(im.qvec).T @ im.tvec for im in images.values()])


def voxel_downsample(xyz: np.ndarray, colors: np.ndarray | None,
                     density: float):
    """Downsample to ~``density`` points per m³: voxel size = density^(-1/3),
    one (averaged) point per occupied voxel."""
    if xyz.shape[0] == 0:
        return xyz, colors
    voxel = max(density, 1e-9) ** (-1.0 / 3.0)
    cells = np.floor(xyz / voxel).astype(np.int64)
    lo = cells.min(axis=0)
    span = cells.max(axis=0) - lo + 1
    if float(np.prod(span.astype(np.float64))) < 2.0 ** 62:
        # One int64 key per cell in the rows' lexicographic order: the
        # same first rows, in the same order, as np.unique(axis=0), at a
        # fraction of its cost.
        c = cells - lo
        key = (c[:, 0] * span[1] + c[:, 1]) * span[2] + c[:, 2]
        _, first = np.unique(key, return_index=True)
    else:
        _, first = np.unique(cells, axis=0, return_index=True)
    return xyz[first], (colors[first] if colors is not None else None)


def _read_tile(f: Path):
    """(xyz, rgb or None) of one LiDAR tile, or None for another file."""
    if f.suffix in (".laz", ".las"):
        from . import laz as laz_io  # native LASzip codec

        pts = laz_io.read_points(f)
        xyz = np.stack([pts["x"], pts["y"], pts["z"]], -1).astype(np.float32)
        rgb = (np.stack([pts["red"], pts["green"], pts["blue"]],
                        -1).astype(np.float32) / 65535.0
               if "red" in pts else None)
    elif f.suffix == ".ply":
        xyz, rgb = fetch_point_cloud(f)
    elif f.suffix == ".npy":
        xyz, rgb = np.load(f), None
    elif f.suffix == ".npz":
        z = np.load(f)
        xyz, rgb = z["xyz"], z.get("rgb")
    else:
        return None
    return xyz, rgb


def read_lidar_tiles(lidar_dir: str | Path) -> list:
    """Every LiDAR tile of ``lidar_dir`` decoded once, up to eight at a
    time (the LAZ codec releases the GIL): [(xyz, rgb or None)] in file
    order, [] without the directory."""
    from concurrent.futures import ThreadPoolExecutor

    lidar_dir = Path(lidar_dir)
    if not lidar_dir.exists():
        return []
    files = sorted(lidar_dir.iterdir())
    with ThreadPoolExecutor(8) as pool:
        return [t for t in pool.map(_read_tile, files) if t is not None]


def load_lidar_tiles(lidar_dir: str | Path, corner_min: np.ndarray,
                     corner_max: np.ndarray, density: float,
                     tiles: list | None = None):
    """Read LiDAR tiles overlapping the chunk box and downsample.  Tiles may
    be .laz/.las (native LASzip codec) or .ply/.npy/.npz({'xyz','rgb'});
    ``tiles`` (``read_lidar_tiles``' list) saves reading them again."""
    lidar_dir = Path(lidar_dir)
    if not lidar_dir.exists():
        return None, None
    if tiles is None:
        tiles = read_lidar_tiles(lidar_dir)
    xs, cs = [], []
    for xyz, rgb in tiles:
        m = np.all(xyz[:, :2] >= corner_min[None, :2], axis=1) \
            & np.all(xyz[:, :2] <= corner_max[None, :2], axis=1)
        if m.any():
            xs.append(xyz[m])
            cs.append(rgb[m] if rgb is not None
                      else np.full((int(m.sum()), 3), 0.5))
    if not xs:
        return None, None
    xyz = np.concatenate(xs)
    rgb = np.concatenate(cs)
    return voxel_downsample(xyz, rgb, density)


def fill_temporal_gaps(depth_images: dict, all_depth_images: dict,
                       max_gap_m: float = 10.0) -> dict:
    """Between consecutive selected depth cameras (recording order) less than
    ``max_gap_m`` apart, pull in the skipped intermediate ones
    (``ss_make_chunk.py:324-439`` temporal-gap filling)."""
    if not depth_images:
        return depth_images
    order = sorted(all_depth_images, key=lambda k: all_depth_images[k].name)
    selected = set(depth_images)
    out = dict(depth_images)
    run_start = None
    for prev, nxt in zip(order, order[1:]):
        if prev in selected and nxt not in selected:
            run_start = prev
        elif run_start is not None and nxt in selected:
            c0 = -colmap.qvec2rotmat(
                all_depth_images[run_start].qvec).T \
                @ all_depth_images[run_start].tvec
            c1 = -colmap.qvec2rotmat(all_depth_images[nxt].qvec).T \
                @ all_depth_images[nxt].tvec
            if np.linalg.norm(c1 - c0) < max_gap_m:
                i0 = order.index(run_start)
                i1 = order.index(nxt)
                for k in order[i0 + 1: i1]:
                    out[k] = all_depth_images[k]
            run_start = None
    return out


def make_chunks(
    source_sparse: str | Path,
    output_path: str | Path,
    cfg: ChunkConfig = ChunkConfig(),
    lidar_dir: str | Path | None = None,
) -> list[str]:
    """Split a global COLMAP model into chunk directories.  Returns the list
    of written chunk names (``<i>_<j>``); also writes the aggregated
    ``chunks.txt`` (the ``concat_chunks_info`` artifact)."""
    rng = random.Random(cfg.seed)
    cams, images, pts = colmap.read_model(source_sparse)
    sparse = Path(source_sparse)
    depth_bin = sparse / "images_depths.bin"
    depth_images = colmap.read_images_binary(depth_bin) \
        if depth_bin.exists() else {}

    centers = camera_centers(images)
    keys = list(images)
    bbox_min = centers.min(axis=0)
    bbox_max = centers.max(axis=0)
    extent_xy = bbox_max[:2] - bbox_min[:2]
    n_w = max(1, int(np.ceil(extent_xy[0] / cfg.chunk_size)))
    n_h = max(1, int(np.ceil(extent_xy[1] / cfg.chunk_size)))

    if pts is None:
        raise FileNotFoundError(f"{source_sparse}: no points3D")
    id_to_row = {int(pid): r for r, pid in enumerate(pts.ids)}
    # Per-image 3D points (for the visibility-based camera selection).
    img_pts = {}
    for key in keys:
        pids = images[key].point3D_ids
        rows = np.array([id_to_row[p] for p in pids
                         if p >= 0 and p in id_to_row], np.int64)
        img_pts[key] = pts.xyz[rows] if rows.size else np.zeros((0, 3))

    # Each LiDAR tile is decoded once for every chunk.
    tiles = (read_lidar_tiles(lidar_dir)
             if cfg.lidar_initialisation and lidar_dir is not None else None)
    written = []
    chunk_rows = []
    for i in range(n_w):
        for j in range(n_h):
            cmin = np.array([bbox_min[0] + i * cfg.chunk_size,
                             bbox_min[1] + j * cfg.chunk_size, -1e12])
            cmax = np.array([bbox_min[0] + (i + 1) * cfg.chunk_size,
                             bbox_min[1] + (j + 1) * cfg.chunk_size, 1e12])
            pmin, pmax = cmin.copy(), cmax.copy()
            if i == 0:
                pmin[0] = -1e12
            if j == 0:
                pmin[1] = -1e12
            if i == n_w - 1:
                pmax[0] = 1e12
            if j == n_h - 1:
                pmax[1] = 1e12

            in_box = np.all(pts.xyz < pmax, axis=-1) \
                & np.all(pts.xyz > pmin, axis=-1)

            center = (cmin + cmax) / 2
            half = (cmax - cmin) / 2
            emin = center - 2 * half
            emax = center + 2 * half

            valid = np.zeros(len(keys), bool)
            for ci, key in enumerate(keys):
                c = centers[ci]
                ip = img_pts[key]
                n_pts = int((np.all(ip < pmax, -1)
                             & np.all(ip > pmin, -1)).sum()) if len(ip) \
                    else 0
                if np.all(c < cmax) and np.all(c > cmin):
                    valid[ci] = True
                elif np.all(c < emax) and np.all(c > emin):
                    valid[ci] = n_pts > 20
                if not valid[ci] and n_pts > 10 and cfg.add_far_cams:
                    valid[ci] = rng.uniform(0, 0.5) < n_pts / max(
                        len(ip), 1)

            while valid.sum() > cfg.max_n_cams:
                on = np.nonzero(valid)[0]
                valid[on[rng.randrange(len(on))]] = False

            if valid.sum() <= cfg.min_n_cams:
                continue

            name = f"{i}_{j}"
            out_dir = Path(output_path) / name
            out_colmap = out_dir / "sparse" / "0"
            out_colmap.mkdir(parents=True, exist_ok=True)

            sel_rows = np.nonzero(in_box)[0]
            sel_ids = set(int(p) for p in pts.ids[sel_rows])
            images_out = {}
            for ci, key in enumerate(keys):
                if not valid[ci]:
                    continue
                im = images[key]
                keep = np.array([p >= 0 and int(p) in sel_ids
                                 for p in im.point3D_ids], bool) \
                    if im.point3D_ids.size else np.zeros(0, bool)
                images_out[key] = colmap.ColmapImage(
                    im.id, im.qvec, im.tvec, im.camera_id, im.name,
                    im.xys[keep], im.point3D_ids[keep])

            # LiDAR merge.
            extra_xyz = extra_rgb = None
            if cfg.lidar_initialisation and lidar_dir is not None:
                extra_xyz, extra_rgb = load_lidar_tiles(
                    lidar_dir, cmin, cmax, cfg.lidar_downsample_density,
                    tiles)

            xyz_out = pts.xyz[sel_rows]
            rgb_out = pts.rgb[sel_rows]
            err_out = pts.error[sel_rows]
            ids_out = pts.ids[sel_rows]
            if extra_xyz is not None and len(extra_xyz):
                base_id = int(pts.ids.max()) + 1
                xyz_out = np.concatenate([xyz_out, extra_xyz])
                rgb_out = np.concatenate(
                    [rgb_out, np.clip(extra_rgb * 255, 0,
                                      255).astype(np.uint8)])
                err_out = np.concatenate(
                    [err_out, np.zeros(len(extra_xyz))])
                ids_out = np.concatenate(
                    [ids_out,
                     base_id + np.arange(len(extra_xyz), dtype=np.int64)])

            pts_out = colmap.ColmapPoints(
                xyz=xyz_out, rgb=rgb_out, error=err_out, ids=ids_out)
            colmap.write_model(cams, images_out, pts_out, out_colmap)

            # GT-constraint cloud for this chunk (chunk.ply, the
            # compare_points_to_gt input).
            store_point_cloud(out_dir / "chunk.ply", xyz_out, rgb_out)

            # Depth-only cameras in the chunk + temporal gap fill.
            if depth_images:
                sel_depth = {}
                for k, dim in depth_images.items():
                    c = -colmap.qvec2rotmat(dim.qvec).T @ dim.tvec
                    if np.all(c < cmax) and np.all(c > cmin):
                        sel_depth[k] = dim
                sel_depth = fill_temporal_gaps(sel_depth, depth_images)
                colmap.write_images_binary(sel_depth,
                                           out_colmap / "images_depths.bin")

            (out_dir / "center.txt").write_text(
                " ".join(map(str, center)))
            (out_dir / "extent.txt").write_text(
                " ".join(map(str, cmax - cmin)))
            written.append(name)
            chunk_rows.append((name, center, cmax - cmin))

    # concat_chunks_info: the aggregated chunks.txt.
    lines = [f"{n} {c[0]} {c[1]} {c[2]} {e[0]} {e[1]} {e[2]}"
             for n, c, e in chunk_rows]
    Path(output_path).mkdir(parents=True, exist_ok=True)
    (Path(output_path) / "chunks.txt").write_text("\n".join(lines) + "\n")
    return written
