"""COLMAP sparse-model IO: cameras / images / points3D, binary and text,
a copy of ``street_sparse_3dgs_tpu/data/colmap.py`` (host code, numpy and
``struct``): files written by either package read back equal in the other,
and binary writes are byte-identical.

Covers read/write of cameras.bin/.txt, images.bin/.txt, points3D.bin/.txt,
plus the street-sparse fork's ``images_depths.bin`` (identical layout to
images.bin, used for depth-only virtual cameras).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

CAMERA_MODELS = {
    # model_id: (name, num_params)
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}
CAMERA_MODEL_NPARAMS = {name: n for _, (name, n) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray          # [4] wxyz world->camera rotation
    tvec: np.ndarray          # [3] world->camera translation
    camera_id: int
    name: str
    xys: np.ndarray           # [P, 2] feature points
    point3D_ids: np.ndarray   # [P] int64 (-1 = unmatched)


@dataclass
class ColmapPoints:
    xyz: np.ndarray           # [N, 3] float64
    rgb: np.ndarray           # [N, 3] uint8
    error: np.ndarray         # [N]
    ids: np.ndarray           # [N] int64
    # Track info kept flat (optional; empty allowed for synthetic models):
    track_image_ids: list | None = None
    track_point2d_idxs: list | None = None


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> wxyz quaternion (eigenvector method, matching the
    reference's ``rotmat2qvec`` sign convention)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


# ---------------------------------------------------------------------------
# cameras


def read_cameras_binary(path) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cid, mid, w, h = struct.unpack("<iiQQ", f.read(24))
            name, nparams = CAMERA_MODELS[mid]
            params = np.array(struct.unpack(f"<{nparams}d",
                                            f.read(8 * nparams)))
            cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def write_cameras_binary(cams: dict[int, ColmapCamera], path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            mid = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def read_cameras_text(path) -> dict[int, ColmapCamera]:
    cams = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cid = int(parts[0])
        cams[cid] = ColmapCamera(cid, parts[1], int(parts[2]), int(parts[3]),
                                 np.array([float(p) for p in parts[4:]]))
    return cams


def write_cameras_text(cams: dict[int, ColmapCamera], path) -> None:
    lines = ["# Camera list with one line of data per camera:",
             "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]"]
    for cam in cams.values():
        params = " ".join(repr(float(p)) for p in cam.params)
        lines.append(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}")
    Path(path).write_text("\n".join(lines) + "\n")


# ---------------------------------------------------------------------------
# images (and the fork's images_depths — same layout)


def _read_string(f) -> str:
    out = b""
    while True:
        c = f.read(1)
        if c == b"\x00" or c == b"":
            return out.decode("utf-8")
        out += c


def read_images_binary(path) -> dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            vals = struct.unpack("<idddddddi", f.read(64))
            iid = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            cam_id = vals[8]
            name = _read_string(f)
            (npts,) = struct.unpack("<Q", f.read(8))
            data = np.frombuffer(f.read(24 * npts), dtype=np.float64)
            data = data.reshape(npts, 3)
            xys = data[:, :2].copy()
            ids = data[:, 2].view(np.int64).copy()
            images[iid] = ColmapImage(iid, qvec, tvec, cam_id, name, xys, ids)
    return images


def write_images_binary(images: dict[int, ColmapImage], path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec,
                                im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            npts = im.xys.shape[0]
            if npts != im.point3D_ids.shape[0]:
                raise ValueError(
                    f"image {im.name}: xys ({npts}) and point3D_ids "
                    f"({im.point3D_ids.shape[0]}) length mismatch")
            f.write(struct.pack("<Q", npts))
            data = np.empty((npts, 3), np.float64)
            data[:, :2] = im.xys
            data[:, 2] = im.point3D_ids.astype(np.int64).view(np.float64)
            f.write(data.tobytes())


def read_images_text(path) -> dict[int, ColmapImage]:
    images = {}
    lines = [ln.strip() for ln in Path(path).read_text().splitlines()
             if ln.strip() and not ln.strip().startswith("#")]
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        iid = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        elems = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array([float(e) for e in elems]).reshape(-1, 3) \
            if elems else np.zeros((0, 3))
        images[iid] = ColmapImage(iid, qvec, tvec, cam_id, name,
                                  xys[:, :2], xys[:, 2].astype(np.int64))
    return images


def write_images_text(images: dict[int, ColmapImage], path) -> None:
    lines = ["# Image list with two lines of data per image:",
             "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME",
             "#   POINTS2D[] as (X, Y, POINT3D_ID)"]
    for im in images.values():
        q = " ".join(repr(float(v)) for v in im.qvec)
        t = " ".join(repr(float(v)) for v in im.tvec)
        lines.append(f"{im.id} {q} {t} {im.camera_id} {im.name}")
        pts = " ".join(f"{x} {y} {int(pid)}" for (x, y), pid
                       in zip(im.xys, im.point3D_ids))
        lines.append(pts)
    Path(path).write_text("\n".join(lines) + "\n")


# ---------------------------------------------------------------------------
# points3D


# One points3D.bin record before its track: id, xyz, rgb, error, track
# length (51 bytes, unaligned).
_POINT_RECORD = np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                          ("error", "<f8"), ("tlen", "<u8")])


def read_points3d_binary(path) -> ColmapPoints:
    """points3D.bin; the records are located by one pass over the track
    lengths and read as numpy views."""
    data = Path(path).read_bytes()
    (n,) = struct.unpack_from("<Q", data, 0)
    if n == 0:      # as the JAX reader gives an empty file: flat arrays
        return ColmapPoints(xyz=np.array([]), rgb=np.array([], np.uint8),
                            error=np.array([]),
                            ids=np.array([], np.int64),
                            track_image_ids=[], track_point2d_idxs=[])
    size = _POINT_RECORD.itemsize
    starts = np.empty(n, np.int64)
    pos = 8
    for i in range(n):
        starts[i] = pos
        pos += size + 8 * int.from_bytes(data[pos + 43:pos + 51], "little")
    raw = np.frombuffer(data, np.uint8)
    rec = raw[starts[:, None] + np.arange(size)].copy().view(
        _POINT_RECORD).reshape(n)
    tlen = rec["tlen"].astype(np.int64)
    nb = 8 * tlen
    first = np.cumsum(nb) - nb
    idx = np.repeat(starts + size - first, nb) + np.arange(int(nb.sum()))
    track = raw[idx].view(np.int32).reshape(-1, 2)
    cuts = np.cumsum(tlen)[:-1]
    t_img = np.split(np.ascontiguousarray(track[:, 0]), cuts)
    t_p2d = np.split(np.ascontiguousarray(track[:, 1]), cuts)
    return ColmapPoints(
        xyz=rec["xyz"].astype(np.float64), rgb=rec["rgb"].astype(np.uint8),
        error=rec["error"].astype(np.float64),
        ids=rec["id"].astype(np.int64),
        track_image_ids=t_img, track_point2d_idxs=t_p2d)


def write_points3d_binary(pts: ColmapPoints, path) -> None:
    """points3D.bin, the records and tracks laid out with numpy."""
    n = pts.xyz.shape[0]
    if pts.track_image_ids:
        tlen = np.array([len(t) for t in pts.track_image_ids], np.int64)
    else:
        tlen = np.zeros(n, np.int64)
    rec = np.empty(n, _POINT_RECORD)
    rec["id"] = np.asarray(pts.ids, np.int64).astype(np.uint64)
    rec["xyz"] = pts.xyz
    rec["rgb"] = np.asarray(pts.rgb).astype(np.uint8)
    rec["error"] = pts.error
    rec["tlen"] = tlen
    size = _POINT_RECORD.itemsize
    starts = 8 + size * np.arange(n, dtype=np.int64) + 8 * (
        np.cumsum(tlen) - tlen)
    buf = np.zeros(8 + size * n + 8 * int(tlen.sum()), np.uint8)
    buf[:8] = np.frombuffer(struct.pack("<Q", n), np.uint8)
    buf[starts[:, None] + np.arange(size)] = rec.view(np.uint8).reshape(
        n, size)
    if tlen.any():
        track = np.empty((int(tlen.sum()), 2), np.int32)
        track[:, 0] = np.concatenate(pts.track_image_ids)
        track[:, 1] = np.concatenate(pts.track_point2d_idxs)
        rows = np.repeat(starts + size, tlen) + 8 * (
            np.arange(int(tlen.sum())) - np.repeat(np.cumsum(tlen) - tlen,
                                                   tlen))
        buf[rows[:, None] + np.arange(8)] = track.view(np.uint8).reshape(
            -1, 8)
    Path(path).write_bytes(buf.tobytes())


def read_points3d_text(path) -> ColmapPoints:
    xyzs, rgbs, errs, ids = [], [], [], []
    t_img, t_p2d = [], []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        ids.append(int(parts[0]))
        xyzs.append([float(p) for p in parts[1:4]])
        rgbs.append([int(p) for p in parts[4:7]])
        errs.append(float(parts[7]))
        track = np.array([int(p) for p in parts[8:]], np.int32)
        t_img.append(track[0::2])
        t_p2d.append(track[1::2])
    return ColmapPoints(
        xyz=np.array(xyzs), rgb=np.array(rgbs, np.uint8),
        error=np.array(errs), ids=np.array(ids, np.int64),
        track_image_ids=t_img, track_point2d_idxs=t_p2d)


def read_model(sparse_dir):
    """Read (cameras, images, points) from a COLMAP sparse dir, preferring
    binary (reference fallback order, ``scene/dataset_readers.py:253-262``)."""
    sparse = Path(sparse_dir)
    if (sparse / "cameras.bin").exists():
        cams = read_cameras_binary(sparse / "cameras.bin")
        images = read_images_binary(sparse / "images.bin")
        pts = (read_points3d_binary(sparse / "points3D.bin")
               if (sparse / "points3D.bin").exists() else None)
    else:
        cams = read_cameras_text(sparse / "cameras.txt")
        images = read_images_text(sparse / "images.txt")
        pts = (read_points3d_text(sparse / "points3D.txt")
               if (sparse / "points3D.txt").exists() else None)
    return cams, images, pts


def write_model(cams, images, pts, sparse_dir, binary: bool = True) -> None:
    sparse = Path(sparse_dir)
    sparse.mkdir(parents=True, exist_ok=True)
    if binary:
        write_cameras_binary(cams, sparse / "cameras.bin")
        write_images_binary(images, sparse / "images.bin")
        if pts is not None:
            write_points3d_binary(pts, sparse / "points3D.bin")
    else:
        write_cameras_text(cams, sparse / "cameras.txt")
        write_images_text(images, sparse / "images.txt")
