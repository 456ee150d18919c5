"""PyTorch port, image IO without PIL (``data/jpeg.py``, ``data/png.py``):
the baseline JPEG decoder bit for bit against PIL (libjpeg-turbo) on files
PIL writes (4:4:4, 4:2:2, 4:2:0, grey, restart markers, odd sizes), files
it refuses named with the reason, the encoder's output decoded alike by
PIL and the port with PIL's own PSNR at the same quality (less 0.5 dB) and
PIL's tables, the bicubic and nearest resizes bit for bit against PIL's,
the EXIF GPS reader against ``_getexif()[34853]``, and the scene loader
on a JPEG project and at half size with PIL blocked, equal to JAX's."""

import io
import sys

import numpy as np
import pytest
import torch
from PIL import Image, TiffImagePlugin

from street_sparse_3dgs_tpu.data import scene as jscene
from street_sparse_3dgs_tpu.preprocess import colmap_runner as jrunner
from street_sparse_3dgs_tpu_torch.data import jpeg, png
from street_sparse_3dgs_tpu_torch.data import scene as tscene
from street_sparse_3dgs_tpu_torch.preprocess import colmap_runner as trunner
from test_torch_data import assert_batches_equal, scene_pair

torch.set_num_threads(1)


def texture(h: int, w: int, channels: int, seed: int = 0) -> np.ndarray:
    """Smooth colour ramps plus noise: blocks with and without AC terms."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([(x * 3 + y) % 256, (y * 5) % 256, (x * y) % 256],
                 -1).astype(np.float32) + rng.normal(0, 20, (h, w, 3))
    a = np.clip(a, 0, 255).astype(np.uint8)
    return a[..., 0] if channels == 1 else a


def pil_jpeg(a: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "JPEG", **kw)
    return buf.getvalue()


def psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


DECODE_CASES = {
    "444": dict(subsampling=0),
    "422": dict(subsampling=1),
    "420": dict(subsampling=2),
    "grey": dict(),
    "420 restart every MCU": dict(subsampling=2, restart_marker_blocks=1),
    "420 restart every row": dict(subsampling=2, restart_marker_rows=1),
    "grey restart every 3": dict(restart_marker_blocks=3),
    "444 restart every 5": dict(subsampling=0, restart_marker_blocks=5),
}
SIZES = [(1, 1), (2, 3), (8, 8), (17, 23), (33, 65), (100, 37), (96, 128)]


@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decoder_matches_pil(case, quality):
    """``decode_jpeg`` equals ``np.asarray(Image.open(...))`` bit for bit at
    every size, sizes that are no multiple of the MCU included."""
    for h, w in SIZES:
        a = texture(h, w, 1 if case.startswith("grey") else 3)
        data = pil_jpeg(a, quality=quality, **DECODE_CASES[case])
        want = np.asarray(Image.open(io.BytesIO(data)))
        got = jpeg.decode_jpeg(data)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w}")


def test_read_image_reads_jpeg_and_png(tmp_path):
    a = texture(40, 52, 3, seed=3)
    Image.fromarray(a).save(tmp_path / "a.jpg", quality=90)
    Image.fromarray(a).save(tmp_path / "a.png")
    np.testing.assert_array_equal(png.read_image(tmp_path / "a.jpg"),
                                  np.asarray(Image.open(tmp_path / "a.jpg")))
    np.testing.assert_array_equal(png.read_image(tmp_path / "a.png"), a)
    (tmp_path / "a.gif").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="a.gif"):
        png.read_image(tmp_path / "a.gif")


@pytest.mark.parametrize("kind", ["progressive", "not a jpeg", "truncated"])
def test_decoder_refuses_with_the_file_and_reason(tmp_path, kind):
    a = texture(32, 32, 3)
    path = tmp_path / "x.jpg"
    if kind == "progressive":
        path.write_bytes(pil_jpeg(a, progressive=True))
        reason = "progressive"
    elif kind == "not a jpeg":
        path.write_bytes(b"\x89PNG\r\n\x1a\n")
        reason = "SOI"
    else:
        path.write_bytes(pil_jpeg(a)[:40])
        reason = "truncated|frame"
    with pytest.raises(ValueError, match=f"x.jpg.*({reason})"):
        jpeg.read_jpeg(path)


@pytest.mark.parametrize("quality", [85, 95])
@pytest.mark.parametrize("channels,subsampling", [(3, "4:2:0"), (3, "4:4:4"),
                                                  (1, "4:2:0")])
def test_encoder_quality_against_pil(channels, subsampling, quality):
    """PIL and the port decode the port's file to the same array, whose
    PSNR is at least PIL's own encode's at the same quality and
    subsampling, less 0.5 dB (a grey image is one component)."""
    a = texture(96, 136, channels, seed=1)
    data = jpeg.encode_jpeg(a, quality, subsampling)
    ours = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), ours)
    pil = np.asarray(Image.open(io.BytesIO(pil_jpeg(
        a, quality=quality, subsampling=0 if subsampling == "4:4:4" else 2))))
    assert psnr(ours, a) >= psnr(pil, a) - 0.5


def _segments(data: bytes, marker: int) -> list:
    out, pos = [], 2
    while pos + 4 <= len(data) and data[pos] == 0xFF and data[pos + 1] != 0xDA:
        n = int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] == marker:
            out.append(data[pos + 4:pos + 2 + n])
        pos += 2 + n
    return out


@pytest.mark.parametrize("quality", [1, 30, 50, 85, 95, 100])
def test_encoder_tables_are_pils(quality):
    """The IJG quality-scaled quantization tables and the standard Huffman
    tables, segment for segment as PIL (libjpeg) writes them."""
    a = texture(32, 32, 3)
    ours = jpeg.encode_jpeg(a, quality)
    pil = pil_jpeg(a, quality=quality, subsampling=2)
    assert b"".join(_segments(ours, 0xDB)) == b"".join(_segments(pil, 0xDB))
    assert sorted(_segments(ours, 0xC4)) == sorted(_segments(pil, 0xC4))


def test_encoder_refuses_bad_arrays():
    with pytest.raises(ValueError):
        jpeg.encode_jpeg(np.zeros((4, 4, 4), np.uint8))
    with pytest.raises(ValueError):
        jpeg.encode_jpeg(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        jpeg.encode_jpeg(np.zeros((4, 4, 3), np.uint8), subsampling="4:1:1")


RESIZE_SIZES = [(37, 53), (64, 64), (1, 5), (5, 1), (200, 120)]


@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("direction", ["up", "down", "mixed"])
def test_resize_bicubic_matches_pil(mode, direction):
    """PIL's default ``resize`` (bicubic, 22-bit fixed point, a horizontal
    then a vertical pass) bit for bit."""
    rng = np.random.default_rng(1)
    for h, w in RESIZE_SIZES:
        a = rng.integers(0, 256, (h, w) if mode == "L" else (h, w, 3),
                         dtype=np.uint8)
        size = {"up": (w * 2 + 1, h * 3), "down": (max(1, w // 3),
                                                   max(1, h // 2)),
                "mixed": (max(1, int(w / 2.7)), int(h * 1.3) + 1)}[direction]
        np.testing.assert_array_equal(
            png.resize_bicubic(a, size),
            np.asarray(Image.fromarray(a, mode).resize(size)),
            err_msg=f"{h}x{w} -> {size}")


def test_resize_nearest_pil_matches_pil():
    rng = np.random.default_rng(2)
    for h, w in ((7, 13), (100, 37), (48, 64)):
        a = rng.integers(0, 256, (h, w), dtype=np.uint8)
        for size in ((w * 3, h * 2), (w // 3 + 1, h // 2 + 1), (w + 5, h),
                     (17, 11)):
            np.testing.assert_array_equal(
                png.resize_nearest_pil(a, size),
                np.asarray(Image.fromarray(a).resize(size, Image.NEAREST)))


def test_encode_png_is_write_png(tmp_path):
    a = texture(20, 30, 3)
    png.write_png(tmp_path / "a.png", a)
    assert png.encode_png(a) == (tmp_path / "a.png").read_bytes()
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")),
                                  a)


def gps_jpeg(path, lat, lon, order="<"):
    """A JPEG whose EXIF GPS IFD PIL writes: tags 1-4 (and 5, altitude)."""
    img = Image.fromarray(texture(16, 16, 3))
    exif = img.getexif()
    r = TiffImagePlugin.IFDRational
    exif[0x8825] = {1: "N" if lat >= 0 else "S",
                    2: tuple(r(v) for v in _dms(abs(lat))),
                    3: "E" if lon >= 0 else "W",
                    4: tuple(r(v) for v in _dms(abs(lon))),
                    5: 0, 6: r(12.5)}
    exif.endian = order
    img.save(path, exif=exif.tobytes())


def _dms(deg: float):
    d = int(deg)
    m = int((deg - d) * 60)
    return d, m, round((deg - d - m / 60) * 3600, 4)


@pytest.mark.parametrize("order", ["<", ">"])
def test_exif_gps_matches_pil(tmp_path, order):
    """Tags 1-4 equal PIL's ``_getexif()[34853]`` (rationals as floats),
    and ``_exif_gps_positions`` equals the JAX package's on a folder of
    tagged, untagged and PNG images."""
    (tmp_path / "cam1").mkdir()
    for i, (lat, lon) in enumerate(((52.37, 4.89), (-33.86, 151.21),
                                    (40.71, -74.0))):
        gps_jpeg(tmp_path / "cam1" / f"{i}.jpg", lat, lon, order)
    Image.fromarray(texture(8, 8, 3)).save(tmp_path / "cam1" / "plain.jpg")
    Image.fromarray(texture(8, 8, 3)).save(tmp_path / "cam1" / "p.png")
    for p in sorted((tmp_path / "cam1").glob("*.jpg")):
        want = {k: v for k, v in (Image.open(p)._getexif() or {}).get(
            34853, {}).items() if k in (1, 2, 3, 4)}
        got = jpeg.exif_gps(p)
        assert set(got) == set(want)
        for k, v in want.items():
            if isinstance(v, tuple):
                assert got[k] == tuple(float(x) for x in v)
            else:
                assert got[k] == v
    assert trunner._exif_gps_positions(tmp_path) == \
        jrunner._exif_gps_positions(tmp_path)
    assert len(trunner._exif_gps_positions(tmp_path)) == 3


@pytest.mark.parametrize("resolution", [1, 2])
def test_scene_loads_jpeg_and_resized_without_pil(tmp_path, monkeypatch,
                                                  resolution):
    """A JPEG project at its own size and at half size: the port's
    ``CameraStream`` batches with PIL blocked in ``sys.modules`` equal the
    JAX package's (decoded and resized by PIL)."""
    cfg_kw = dict(eval=True, depths="depths", alpha_masks="masks")
    info_j, info_t = scene_pair(tmp_path, cfg_kw, with_masks=True,
                                jpeg=True)
    kw = dict(resolution=resolution, seed=0, num_workers=0)
    want = list(jscene.CameraStream(info_j.train_cameras, **kw))
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError):
        import PIL  # noqa: F401
    got = list(tscene.CameraStream(info_t.train_cameras, device="cpu", **kw))
    assert_batches_equal(want, got)
