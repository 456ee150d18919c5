"""PyTorch port, data layer: COLMAP files across the two packages (binary
writes byte-identical), ``load_scene_info`` and ``CameraStream`` against
the JAX package on the same COLMAP project, the PNG codec against PIL and
``resize_nearest`` against OpenCV, and the resolution policy.  Every
comparison here is exact: both packages run the same numpy on the same
bytes."""

import json
import shutil
import struct
import zlib

import numpy as np
import pytest
import torch

from street_sparse_3dgs_tpu.config import ModelConfig as JModelConfig
from street_sparse_3dgs_tpu.data import colmap as jcolmap
from street_sparse_3dgs_tpu.data import scene as jscene
from street_sparse_3dgs_tpu_torch.config import ModelConfig
from street_sparse_3dgs_tpu_torch.data import colmap, png
from street_sparse_3dgs_tpu_torch.data import scene as tscene

torch.set_num_threads(1)


def make_model(mod, n_cams=4, n_pts=50, seed=0, model="PINHOLE"):
    """tests/test_data.py's synthetic model, built with ``mod`` (either
    package's colmap module)."""
    rng = np.random.default_rng(seed)
    cams = {1: mod.ColmapCamera(1, model, 64, 48,
                                np.array([60.0, 60.0, 31.5, 23.5])
                                if model == "PINHOLE"
                                else np.array([60.0, 31.5, 23.5]))}
    images = {}
    for i in range(1, n_cams + 1):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        if q[0] < 0:
            q = -q
        images[i] = mod.ColmapImage(
            i, q, rng.normal(size=3), 1, f"cam{i:03d}.png",
            rng.uniform(0, 64, size=(5, 2)),
            rng.integers(-1, n_pts, size=5).astype(np.int64))
    pts = mod.ColmapPoints(
        xyz=rng.normal(size=(n_pts, 3)),
        rgb=rng.integers(0, 255, size=(n_pts, 3)).astype(np.uint8),
        error=rng.uniform(0, 1, n_pts), ids=np.arange(n_pts, dtype=np.int64),
        track_image_ids=[np.array([1, 2], np.int32)] * n_pts,
        track_point2d_idxs=[np.array([0, 1], np.int32)] * n_pts)
    return cams, images, pts


def assert_models_equal(a, b):
    ca, ia, pa = a
    cb, ib, pb = b
    assert set(ca) == set(cb) and set(ia) == set(ib)
    for k in ca:
        assert (ca[k].id, ca[k].model, ca[k].width, ca[k].height) == \
            (cb[k].id, cb[k].model, cb[k].width, cb[k].height)
        np.testing.assert_array_equal(ca[k].params, cb[k].params)
    for k in ia:
        for f in ("qvec", "tvec", "xys", "point3D_ids"):
            np.testing.assert_array_equal(getattr(ia[k], f),
                                          getattr(ib[k], f), err_msg=f)
        assert (ia[k].id, ia[k].camera_id, ia[k].name) == \
            (ib[k].id, ib[k].camera_id, ib[k].name)
    if pa is not None:
        for f in ("xyz", "rgb", "error", "ids"):
            np.testing.assert_array_equal(getattr(pa, f), getattr(pb, f))
        for f in ("track_image_ids", "track_point2d_idxs"):
            for x, y in zip(getattr(pa, f), getattr(pb, f)):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("model", ["PINHOLE", "SIMPLE_PINHOLE"])
def test_colmap_binary_across_packages(tmp_path, model):
    """A model written by either package reads back equal in the other, and
    the two packages' binary files are byte-identical (images_depths.bin
    too: the same writer)."""
    for writer, reader, name in ((jcolmap, colmap, "j"), (colmap, jcolmap,
                                                          "t")):
        m = make_model(writer, model=model)
        writer.write_model(*m, tmp_path / name, binary=True)
        assert_models_equal(m, reader.read_model(tmp_path / name))
        writer.write_images_binary(m[1], tmp_path / name / "depths.bin")
        assert_models_equal((m[0], m[1], None), (
            m[0], reader.read_images_binary(tmp_path / name / "depths.bin"),
            None))
    for f in ("cameras.bin", "images.bin", "points3D.bin", "depths.bin"):
        assert (tmp_path / "j" / f).read_bytes() == \
            (tmp_path / "t" / f).read_bytes(), f


def test_colmap_text_across_packages(tmp_path):
    """Cameras, images and points in the text format, both ways, files
    byte-identical."""
    for writer, reader, name in ((jcolmap, colmap, "j"), (colmap, jcolmap,
                                                          "t")):
        cams, images, pts = make_model(writer)
        d = tmp_path / name
        writer.write_model(cams, images, None, d, binary=False)
        assert_models_equal((cams, images, None), reader.read_model(d)[:2]
                            + (None,))
    for f in ("cameras.txt", "images.txt"):
        assert (tmp_path / "j" / f).read_bytes() == \
            (tmp_path / "t" / f).read_bytes(), f
    lines = ["# 3D point list", "0 1.5 -2.25 3.0 10 20 30 0.5 1 0 2 1",
             "7 0.0 0.0 0.0 1 2 3 0.0"]
    (tmp_path / "points3D.txt").write_text("\n".join(lines) + "\n")
    assert_models_equal(
        ({}, {}, jcolmap.read_points3d_text(tmp_path / "points3D.txt")),
        ({}, {}, colmap.read_points3d_text(tmp_path / "points3D.txt")))


def test_qvec_rotmat_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(10):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        np.testing.assert_array_equal(colmap.qvec2rotmat(q),
                                      jcolmap.qvec2rotmat(q))
        R = colmap.qvec2rotmat(q)
        np.testing.assert_array_equal(colmap.rotmat2qvec(R),
                                      jcolmap.rotmat2qvec(R))


def make_scene_dir(tmp_path, with_masks=False, jpeg=False):
    """tests/test_data.py's ``make_scene_dir`` layout (its own copy): four
    64x48 PINHOLE views, 16-bit depth PNGs with depth_params.json,
    test.txt naming cam001, two depth-only cameras; optionally RGB alpha
    masks, and JPEG images (which need PIL)."""
    from PIL import Image

    sparse = tmp_path / "sparse" / "0"
    sparse.mkdir(parents=True)
    cams, images, pts = make_model(jcolmap)
    if jpeg:
        for im in images.values():
            im.name = im.name.replace(".png", ".jpg")
    jcolmap.write_model(cams, images, pts, sparse, binary=True)
    (tmp_path / "images").mkdir()
    rng = np.random.default_rng(2)
    for im in images.values():
        arr = rng.integers(0, 255, size=(48, 64, 3)).astype(np.uint8)
        Image.fromarray(arr).save(tmp_path / "images" / im.name)
    (sparse / "test.txt").write_text(f"{images[1].name}\n")
    (tmp_path / "depths").mkdir()
    for im in images.values():
        d = rng.integers(0, 65535, size=(48, 64)).astype(np.uint16)
        Image.fromarray(d).save(tmp_path / "depths" /
                                (im.name.rsplit(".", 1)[0] + ".png"))
    dp = {im.name.rsplit(".", 1)[0]: {"scale": 1.2 + 0.1 * i, "offset": 0.1}
          for i, im in enumerate(images.values())}
    (sparse / "depth_params.json").write_text(json.dumps(dp))
    dimages = {10 + i: jcolmap.ColmapImage(
        10 + i, np.array([1.0, 0, 0, 0]), np.zeros(3), 1,
        images[i].name, np.zeros((0, 2)), np.zeros(0, np.int64))
        for i in range(1, 3)}
    jcolmap.write_images_binary(dimages, sparse / "images_depths.bin")
    if with_masks:
        (tmp_path / "masks").mkdir()
        for im in images.values():
            m = rng.integers(0, 255, size=(48, 64, 3)).astype(np.uint8)
            Image.fromarray(m).save(tmp_path / "masks" / f"{im.name}.png")
    return tmp_path


SCENE_CFGS = {
    "eval+depth-only": dict(eval=True, depths="depths",
                            additional_depth_maps=True),
    "no eval": dict(depths="depths"),
    "masks+exposure split": dict(eval=True, depths="depths",
                                 alpha_masks="masks", train_test_exp=True),
}


def scene_pair(tmp_path, cfg_kw, llffhold=None, **dir_kw):
    """(JAX SceneInfo, port SceneInfo), each loaded from its own copy of the
    same project (the first load writes points3D.ply)."""
    src = make_scene_dir(tmp_path / "j", **dir_kw)
    shutil.copytree(src, tmp_path / "t")
    info_j = jscene.load_scene_info(src, JModelConfig(**cfg_kw), llffhold)
    info_t = tscene.load_scene_info(tmp_path / "t", ModelConfig(**cfg_kw),
                                    llffhold)
    return info_j, info_t


def assert_infos_equal(cj, ct, tmp_path):
    assert len(cj) == len(ct)
    for a, b in zip(cj, ct):
        for k, v in vars(a).items():
            w = getattr(b, k)
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(w, v, err_msg=k)
            elif k.endswith("_path"):
                assert w.replace(str(tmp_path / "t"), "") == \
                    v.replace(str(tmp_path / "j"), ""), k
            else:
                assert w == v, k


@pytest.mark.parametrize("case", list(SCENE_CFGS) + ["llffhold 2"])
def test_load_scene_info_matches_jax(tmp_path, case):
    """Every field of every camera info (split, depth params with the
    median scale, depth-only cameras, paths), the points and colours, the
    radius and translation equal to JAX's."""
    cfg_kw = SCENE_CFGS.get(case, dict(eval=True, depths="depths"))
    info_j, info_t = scene_pair(tmp_path, cfg_kw,
                                llffhold=2 if case == "llffhold 2" else None,
                                with_masks="masks" in case)
    assert_infos_equal(info_j.train_cameras, info_t.train_cameras, tmp_path)
    assert_infos_equal(info_j.test_cameras, info_t.test_cameras, tmp_path)
    np.testing.assert_array_equal(info_t.points, info_j.points)
    np.testing.assert_array_equal(info_t.colors, info_j.colors)
    assert info_t.nerf_radius == info_j.nerf_radius
    np.testing.assert_array_equal(info_t.translate, info_j.translate)
    if case == "eval+depth-only":
        assert sum(c.is_depth_only for c in info_t.train_cameras) == 2
        assert len(info_t.test_cameras) == 1


def assert_batches_equal(bj, bt):
    assert len(bj) == len(bt)
    for a, b in zip(bj, bt):
        assert getattr(a, "is_depth_only", False) == \
            getattr(b, "is_depth_only", False)
        assert int(a.image_index) == int(b.image_index)
        assert b.image_index.dtype == torch.int32
        for k in ("gt_image", "alpha_mask", "mono_invdepth", "depth_mask",
                  "depth_reliable"):
            np.testing.assert_array_equal(getattr(b, k).numpy(),
                                          np.asarray(getattr(a, k)),
                                          err_msg=k)
        for k in ("viewmatrix", "projmatrix", "campos", "tan_fovx",
                  "tan_fovy", "focal_x", "focal_y"):
            np.testing.assert_array_equal(getattr(b.camera, k).numpy(),
                                          np.asarray(getattr(a.camera, k)),
                                          err_msg=k)
        assert (b.camera.height, b.camera.width) == \
            (a.camera.height, a.camera.width)


@pytest.mark.parametrize("num_workers", [0, 8])
@pytest.mark.parametrize("case", list(SCENE_CFGS))
def test_camera_stream_matches_jax(tmp_path, case, num_workers):
    """Two epochs of shuffled batches (seed 3) in JAX's order with arrays
    equal to JAX's batches: images, alpha masks (RGB masks to grey, the
    exposure split), 16-bit inverse depth, cameras; depth-only batches of
    the depth-only class."""
    cfg_kw = SCENE_CFGS[case]
    info_j, info_t = scene_pair(tmp_path, cfg_kw,
                                with_masks="masks" in case)
    for on_test in (False, True):
        cj = info_j.test_cameras if on_test else info_j.train_cameras
        ct = info_t.test_cameras if on_test else info_t.train_cameras
        kw = dict(resolution=1, seed=3, num_workers=num_workers,
                  train_test_exp=cfg_kw.get("train_test_exp", False),
                  is_test_dataset=on_test)
        sj = jscene.CameraStream(cj, **kw)
        st = tscene.CameraStream(ct, device="cpu", **kw)
        try:
            for _ in range(2):
                assert_batches_equal(list(sj), list(st))
        finally:
            st.close()


@pytest.mark.parametrize("resolution", [2, -1])
def test_camera_stream_resized_and_jpeg_match_jax(tmp_path, resolution):
    """JPEG input and a bicubic resize to half size, decoded and resized
    without PIL, give the JAX package's arrays (depth resized by the
    nearest-neighbour rule)."""
    cfg_kw = dict(eval=True, depths="depths", alpha_masks="masks")
    info_j, info_t = scene_pair(tmp_path, cfg_kw, with_masks=True,
                                jpeg=True)
    kw = dict(resolution=resolution, seed=0, num_workers=0)
    assert_batches_equal(list(jscene.CameraStream(info_j.train_cameras,
                                                  **kw)),
                         list(tscene.CameraStream(info_t.train_cameras,
                                                  device="cpu", **kw)))


def test_camera_stream_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    src = make_scene_dir(tmp_path)
    info = tscene.load_scene_info(src, ModelConfig(eval=True))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tscene.CameraStream(info.train_cameras)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tscene.load_camera_arrays(info.train_cameras[0])


def test_resolution_policy_matches_jax():
    for w, h in ((3200, 2400), (800, 600), (1920, 1088), (1601, 901)):
        for res in (-1, 1, 2, 4, 8, 400, 1000):
            assert tscene.resolve_resolution(w, h, res) == \
                jscene.resolve_resolution(w, h, res)


# ---- PNG codec ------------------------------------------------------------

def encode_filtered(image: np.ndarray, filters) -> bytes:
    """A PNG of ``image`` (uint8 grey/RGB/RGBA or uint16 grey) whose row y
    uses filter ``filters[y % len(filters)]`` (0 None, 1 Sub, 2 Up,
    3 Average, 4 Paeth), encoded per the PNG specification."""
    if image.dtype == np.uint16:
        depth, colour, raw = 16, 0, image.astype(">u2").view(np.uint8)
        raw = raw.reshape(image.shape[0], -1)
        bpp = 2
    else:
        ch = 1 if image.ndim == 2 else image.shape[2]
        depth, colour = 8, {1: 0, 3: 2, 4: 6}[ch]
        raw = image.reshape(image.shape[0], -1)
        bpp = ch
    height, stride = raw.shape
    out = bytearray()
    prev = np.zeros(stride, np.int64)
    for y in range(height):
        cur = raw[y].astype(np.int64)
        a = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        kind = filters[y % len(filters)]
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (a + prev) // 2
        else:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, prev, c))
        out.append(kind)
        out += ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", image.shape[1],
                                         height, depth, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


IMAGE_KINDS = {"L": ((48, 64), np.uint8), "RGB": ((48, 64, 3), np.uint8),
               "RGBA": ((48, 64, 4), np.uint8), "L16": ((48, 64), np.uint16)}


@pytest.mark.parametrize("kind", list(IMAGE_KINDS))
def test_png_reader_matches_pil(tmp_path, kind):
    """``read_png`` gives ``np.asarray(PIL.Image.open(path))`` on files
    written by PIL and on files of each row filter (all five in one file,
    and each alone), random and smooth content; ``write_png`` files read
    back equal in PIL; PIL's grey/RGB conversions equal ``to_grey`` /
    ``to_rgb``."""
    from PIL import Image

    shape, dtype = IMAGE_KINDS[kind]
    rng = np.random.default_rng(1)
    noisy = rng.integers(0, np.iinfo(dtype).max, size=shape).astype(dtype)
    ramp = (np.indices(shape).sum(axis=0) * 7 % np.iinfo(dtype).max
            ).astype(dtype)
    path = tmp_path / "x.png"
    for image in (noisy, ramp):
        Image.fromarray(image).save(path)
        want = np.asarray(Image.open(path))
        got = png.read_png(path)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        for filters in ((0, 1, 2, 3, 4), (0,), (1,), (2,), (3,), (4,)):
            path.write_bytes(encode_filtered(image, filters))
            np.testing.assert_array_equal(png.read_png(path),
                                          np.asarray(Image.open(path)))
            np.testing.assert_array_equal(png.read_png(path), image)
        png.write_png(path, image)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), image)
        if dtype == np.uint8:
            pil = Image.fromarray(image)
            np.testing.assert_array_equal(png.to_grey(image),
                                          np.asarray(pil.convert("L")))
            np.testing.assert_array_equal(png.to_rgb(image),
                                          np.asarray(pil.convert("RGB")))


def test_png_refuses_what_it_cannot_read(tmp_path):
    from PIL import Image

    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).convert("P").save(
        tmp_path / "p.png")
    with pytest.raises(ValueError, match="colour type 3"):
        png.read_png(tmp_path / "p.png")
    (tmp_path / "x.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(tmp_path / "x.png")


@pytest.mark.parametrize("size", [(32, 24), (128, 96), (100, 70), (37, 91),
                                  (64, 48), (1, 1)])
def test_resize_nearest_matches_cv2(size):
    """cv2.resize(..., INTER_NEAREST) of a 48x64 map, down- and up-scales
    and uneven ratios, float32 and uint16."""
    import cv2

    rng = np.random.default_rng(0)
    for a in (rng.random((48, 64)).astype(np.float32),
              rng.integers(0, 65535, (48, 64)).astype(np.uint16)):
        np.testing.assert_array_equal(
            png.resize_nearest(a, size),
            cv2.resize(a, size, interpolation=cv2.INTER_NEAREST))


def test_resize_bicubic_matches_pil(tmp_path):
    """To another size as PIL's default resize; at the image's own size,
    the image itself."""
    from PIL import Image

    a = np.random.default_rng(0).integers(0, 255, (48, 64, 3)).astype(
        np.uint8)
    np.testing.assert_array_equal(
        png.resize_bicubic(a, (32, 24)),
        np.asarray(Image.fromarray(a).resize((32, 24))))
    assert png.resize_bicubic(a, (64, 48)) is a
