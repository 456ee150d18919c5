"""Scene loading: COLMAP dir -> camera infos -> training batches, mirroring
``street_sparse_3dgs_tpu/data/scene.py``:

  - parses the sparse model, builds per-view intrinsics with off-center
    principal points (PINHOLE / SIMPLE_PINHOLE only),
  - loads ``depth_params.json`` and stamps the per-image median scale,
  - eval split from ``test.txt`` (or LLFF hold),
  - depth-only virtual cameras from ``images_depths.bin`` when
    ``additional_depth_maps`` is on,
  - nerf++ normalization (camera-bbox center/radius -> ``cameras_extent``),
  - lazy per-item image/depth/mask loading on the host with the reference's
    resolution policy (powers-of-two downscale; auto-cap 1600px wide when
    ``resolution == -1``), 16-bit PNG inverse-depth scaled by
    ``{scale, offset}``, producing ``CameraBatch`` tuples on ``device``.

Images decode through ``data/png.py`` and ``data/jpeg.py`` and resize
through ``png.resize_bicubic`` (PIL's bicubic, bit for bit): no PIL or
OpenCV is needed for PNG or JPEG projects at any resolution.
"""

from __future__ import annotations

import json
import math
import random
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..config import ModelConfig
from ..core.camera import CameraParams, make_camera
from ..device import DEFAULT_DEVICE, resolve_device
from ..train.step import CameraBatch
from . import colmap, png
from .ply import fetch_point_cloud, store_point_cloud


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


@dataclass
class CameraInfo:
    uid: int
    R: np.ndarray              # camera-to-world rotation (reader convention)
    T: np.ndarray              # world-to-camera translation
    fovx: float
    fovy: float
    primx: float
    primy: float
    width: int
    height: int
    image_name: str
    image_path: str = ""
    depth_path: str = ""
    mask_path: str = ""
    depth_params: dict | None = None
    is_test: bool = False
    is_depth_only: bool = False


@dataclass
class SceneInfo:
    train_cameras: list[CameraInfo]
    test_cameras: list[CameraInfo]
    points: np.ndarray         # [N, 3]
    colors: np.ndarray         # [N, 3] in [0, 1]
    nerf_radius: float         # cameras_extent
    translate: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32))


def _camera_info(extr: colmap.ColmapImage, intr: colmap.ColmapCamera,
                 depths_params, images_dir, depths_dir, masks_dir,
                 test_names, is_depth_only=False) -> CameraInfo:
    if intr.model == "SIMPLE_PINHOLE":
        focal_x = intr.params[0]
        primx = float(intr.params[1]) / intr.width
        primy = float(intr.params[2]) / intr.height
        fovx = focal2fov(focal_x, intr.width)
        fovy = focal2fov(focal_x, intr.height)
    elif intr.model == "PINHOLE":
        primx = float(intr.params[2]) / intr.width
        primy = float(intr.params[3]) / intr.height
        fovx = focal2fov(intr.params[0], intr.width)
        fovy = focal2fov(intr.params[1], intr.height)
    else:
        raise ValueError(
            "Colmap camera model not handled: only undistorted datasets "
            "(PINHOLE or SIMPLE_PINHOLE cameras) supported!")
    stem = extr.name.rsplit(".", 1)[0]
    dp = None
    if depths_params is not None:
        dp = depths_params.get(stem)
    return CameraInfo(
        uid=intr.id, R=colmap.qvec2rotmat(extr.qvec).T, T=np.array(extr.tvec),
        fovx=fovx, fovy=fovy, primx=primx, primy=primy,
        width=intr.width, height=intr.height, image_name=extr.name,
        image_path=str(Path(images_dir) / extr.name) if images_dir else "",
        depth_path=str(Path(depths_dir) / f"{stem}.png") if depths_dir else "",
        mask_path=str(Path(masks_dir) / f"{extr.name}.png") if masks_dir
        else "",
        depth_params=dp, is_test=extr.name in test_names,
        is_depth_only=is_depth_only)


def load_scene_info(source_path: str, cfg: ModelConfig | None = None,
                    llffhold: int | None = None) -> SceneInfo:
    cfg = cfg or ModelConfig()
    src = Path(source_path)
    sparse = src / "sparse" / "0"
    cams, images, pts = colmap.read_model(sparse)

    depths_params = None
    if cfg.depths:
        blob = json.loads((sparse / "depth_params.json").read_text())
        scales = np.array([v["scale"] for v in blob.values()])
        med = np.median(scales[scales > 0]) if (scales > 0).any() else 0.0
        for v in blob.values():
            v["med_scale"] = med
        depths_params = blob

    test_names: set[str] = set()
    if cfg.eval:
        if llffhold:
            names = sorted(im.name for im in images.values())
            test_names = {n for i, n in enumerate(names) if i % llffhold == 0}
        else:
            test_names = {ln.strip() for ln in
                          (sparse / "test.txt").read_text().splitlines()
                          if ln.strip()}

    images_dir = src / (cfg.images or "images")
    depths_dir = (src / cfg.depths) if cfg.depths else ""
    masks_dir = (src / cfg.alpha_masks) if cfg.alpha_masks else ""

    infos = [
        _camera_info(extr, cams[extr.camera_id], depths_params, images_dir,
                     depths_dir, masks_dir, test_names)
        for extr in images.values()]
    infos.sort(key=lambda c: c.image_name)
    train = [c for c in infos if cfg.train_test_exp or not c.is_test]
    test = [c for c in infos if c.is_test]

    if cfg.additional_depth_maps and (sparse / "images_depths.bin").exists():
        dimages = colmap.read_images_binary(sparse / "images_depths.bin")
        train += [
            _camera_info(extr, cams[extr.camera_id], depths_params, "",
                         depths_dir, masks_dir, set(), is_depth_only=True)
            for extr in dimages.values()]

    # Points: .ply preferred (converted once from the bin like the reference).
    ply_path = sparse / "points3D.ply"
    if ply_path.exists():
        xyz, rgb = fetch_point_cloud(ply_path)
    elif pts is not None:
        xyz = pts.xyz.astype(np.float32)
        rgb = pts.rgb.astype(np.float32) / 255.0
        store_point_cloud(ply_path, pts.xyz, pts.rgb)
    else:
        raise FileNotFoundError(f"no points3D in {sparse}")

    radius, translate = nerfpp_norm(train)
    return SceneInfo(train_cameras=train, test_cameras=test, points=xyz,
                     colors=rgb, nerf_radius=radius, translate=translate)


def nerfpp_norm(cam_infos: list[CameraInfo]):
    """Camera-center bounding sphere: radius = 1.1 x max distance to the
    average center (reference ``getNerfppNorm``)."""
    centers = []
    for c in cam_infos:
        w2c = np.eye(4)
        w2c[:3, :3] = c.R.T
        w2c[:3, 3] = c.T
        c2w = np.linalg.inv(w2c)
        centers.append(c2w[:3, 3])
    centers = np.stack(centers)
    avg = centers.mean(axis=0)
    dist = np.linalg.norm(centers - avg, axis=1)
    radius = float(dist.max()) * 1.1
    return radius, -avg


def resolve_resolution(width: int, height: int, resolution: int):
    """The reference resolution policy (``utils/camera_utils.py:64-81``):
    resolution in {1,2,4,8} divides; -1 auto-caps width at 1600px."""
    if resolution in (1, 2, 4, 8):
        return round(width / resolution), round(height / resolution)
    if resolution == -1:
        if width > 1600:
            scale = width / 1600
            return round(width / scale), round(height / scale)
        return width, height
    scale = width / resolution
    return round(width / scale), round(height / scale)


def load_camera_arrays(info: CameraInfo, resolution: int = -1,
                       train_test_exp: bool = False,
                       is_test_dataset: bool = False,
                       device: str | torch.device = DEFAULT_DEVICE):
    """Host-side per-item load (the CameraDataset.__getitem__ analogue):
    the camera on ``device`` and numpy arrays of the images."""
    w, h = resolve_resolution(info.width, info.height, resolution)

    if info.image_path and Path(info.image_path).exists():
        rgb = png.to_rgb(png.read_image(info.image_path))
        img = png.resize_bicubic(rgb, (w, h))
        gt = np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0
    else:
        gt = np.zeros((3, h, w), np.float32)  # depth-only: dummy black image

    alpha = np.ones((1, h, w), np.float32)
    if info.mask_path and Path(info.mask_path).exists():
        grey = png.to_grey(png.read_image(info.mask_path))
        m = png.resize_bicubic(grey, (w, h))
        alpha = (np.asarray(m, np.float32)[None] / 255.0)

    if train_test_exp and info.is_test:
        # Exposure-optimization split (``scene/cameras.py:56-60``): a test
        # view used during training contributes only its LEFT half; at eval
        # it is scored only on its right half.
        if is_test_dataset:
            alpha[..., : w // 2] = 0.0
        else:
            alpha[..., w // 2:] = 0.0

    invdepth = np.zeros((1, h, w), np.float32)
    depth_mask = np.zeros((1, h, w), np.float32)
    depth_reliable = False
    if info.depth_path and Path(info.depth_path).exists() \
            and info.depth_params is not None:
        raw = np.asarray(png.read_image(info.depth_path), np.float32)
        if raw.ndim == 3:
            raw = raw[..., 0]
        raw = png.resize_nearest(raw, (w, h))
        scale = info.depth_params.get("scale", 0.0)
        offset = info.depth_params.get("offset", 0.0)
        invdepth[0] = (raw / 65535.0) * scale + offset
        depth_mask[:] = 1.0
        # Fork behavior: the med_scale reliability check is disabled
        # (``scene/cameras.py:84-88``) — depth is trusted whenever present.
        depth_reliable = True

    camera = make_camera(info.R, info.T, info.fovx, info.fovy, w, h,
                         primx=info.primx, primy=info.primy, device=device)
    return dict(camera=camera, gt_image=gt, alpha_mask=alpha,
                mono_invdepth=invdepth, depth_mask=depth_mask,
                depth_reliable=depth_reliable,
                is_depth_only=info.is_depth_only)


class DepthOnlyCameraBatch(CameraBatch):
    """CameraBatch flavored as depth-only; the training loop reads the class
    attribute ``is_depth_only`` to pick the depth-only step."""

    is_depth_only = True


class CameraStream:
    """Shuffled camera stream yielding ``CameraBatch`` tuples on ``device``
    — the DataLoader(CameraDataset) analogue (lazy per-item host loading,
    ``utils/camera_utils.py:126-147``).

    With ``num_workers > 0`` the PNG decode/resize runs on a persistent
    thread pool with an ordered in-flight window (the reference trains with
    ``DataLoader(num_workers=8, prefetch_factor=1, persistent_workers=True)``,
    ``train_single.py:61``), the yield order identical to the synchronous
    path.  The shuffle draws from ``random.Random(seed)`` as the JAX stream
    does, so both packages visit the views in the same order.  Tensors are
    made on the consuming thread."""

    def __init__(self, infos: list[CameraInfo], resolution: int = -1,
                 seed: int = 0, shuffle: bool = True,
                 train_test_exp: bool = False,
                 is_test_dataset: bool = False,
                 num_workers: int = 8,
                 device: str | torch.device = DEFAULT_DEVICE):
        self.infos = infos
        self.resolution = resolution
        self.rng = random.Random(seed)
        self.shuffle = shuffle
        self.train_test_exp = train_test_exp
        self.is_test_dataset = is_test_dataset
        self.num_workers = num_workers
        self.device = resolve_device(device)
        self.index = {c.image_name: i for i, c in enumerate(infos)}
        self._pool = None

    def _load(self, i: int):
        return i, load_camera_arrays(self.infos[i], self.resolution,
                                     self.train_test_exp,
                                     self.is_test_dataset, device="cpu")

    def _to_batch(self, i, a):
        dev = self.device

        def t(x):
            return torch.as_tensor(x, device=dev)

        cam = a["camera"]
        camera = CameraParams(*(x.to(dev) for x in cam[:7]),
                              height=cam.height, width=cam.width)
        cls = DepthOnlyCameraBatch if a["is_depth_only"] else CameraBatch
        return cls(camera=camera, gt_image=t(a["gt_image"]),
                   alpha_mask=t(a["alpha_mask"]),
                   mono_invdepth=t(a["mono_invdepth"]),
                   depth_mask=t(a["depth_mask"]),
                   depth_reliable=torch.tensor(a["depth_reliable"],
                                               device=dev),
                   image_index=torch.tensor(i, dtype=torch.int32,
                                            device=dev))

    def close(self) -> None:
        """Shut the loader threads down (a stream left open keeps them
        until the process exits)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __iter__(self):
        order = list(range(len(self.infos)))
        if self.shuffle:
            self.rng.shuffle(order)

        if self.num_workers <= 0 or len(order) <= 1:
            for i in order:
                yield self._to_batch(*self._load(i))
            return

        if self._pool is None:          # persistent across epochs
            self._pool = ThreadPoolExecutor(
                max_workers=self.num_workers,
                thread_name_prefix="camera-load")

        window: deque = deque()
        depth = min(len(order), self.num_workers)
        it = iter(order)
        for i in it:
            window.append(self._pool.submit(self._load, i))
            if len(window) >= depth:
                break
        for i in it:
            yield self._to_batch(*window.popleft().result())
            window.append(self._pool.submit(self._load, i))
        while window:
            yield self._to_batch(*window.popleft().result())
