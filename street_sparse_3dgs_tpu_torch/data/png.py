"""Image IO without PIL or OpenCV: a PNG reader and writer on the standard
library's ``zlib``, the colour conversions and the two resizes
the scene loader and the eval need.

The JAX package decodes images with PIL and resizes depth maps with
``cv2.resize(..., INTER_NEAREST)``; neither is installed beside the port on
the card's machine.  This module gives the same arrays:

- ``read_png`` returns what ``np.asarray(PIL.Image.open(path))`` returns for
  a non-interlaced PNG of 8-bit grey, RGB or RGBA, or 16-bit grey (all five
  row filters);
- ``to_rgb`` / ``to_grey`` are PIL's ``convert("RGB")`` / ``convert("L")``
  (integer ITU-R 601-2 luma, as ``Convert.c`` rounds it);
- ``resize_nearest`` is cv2's ``INTER_NEAREST`` index rule,
  ``src = floor(dst * src_size / dst_size)`` clamped to the last index;
- ``resize_bicubic`` is PIL's default ``Image.resize`` (bicubic), bit for
  bit;
- ``read_image`` reads a PNG here and a JPEG through ``data/jpeg.py``.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (channels, mode name)
_COLOUR_TYPES = {0: (1, "L"), 2: (3, "RGB"), 6: (4, "RGBA")}


def is_png(path) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == _SIGNATURE


def _chunks(data: bytes):
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if zlib.crc32(kind + body) != struct.unpack(
                ">I", data[pos + 8 + length:pos + 12 + length])[0]:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        pos += 12 + length


def _paeth_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _average_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (None, Sub, Up, Average, Paeth) of the
    decompressed scanlines."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != height * (stride + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected "
                         f"{height * (stride + 1)}")
    rows = rows.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:      # Sub: a running sum per byte of the pixel
            cur = np.cumsum(line.reshape(-1, bpp).astype(np.uint32), axis=0,
                            dtype=np.uint32).reshape(-1).astype(np.uint8)
        elif kind == 2:      # Up
            cur = line + prev
        elif kind in (3, 4):
            buf = bytearray(line.tobytes())
            (_average_row if kind == 3 else _paeth_row)(buf, prev.tobytes(),
                                                        bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path) -> np.ndarray:
    """[H, W] (grey) or [H, W, 3|4] (RGB, RGBA) uint8, or [H, W] uint16
    (16-bit grey): what ``np.asarray(PIL.Image.open(path))`` gives."""
    data = Path(path).read_bytes()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, colour, _, _, interlace = header
    if colour not in _COLOUR_TYPES or interlace != 0 or \
            depth not in (8, 16) or (depth == 16 and colour != 0):
        raise ValueError(
            f"{path}: PNG of bit depth {depth}, colour type {colour}, "
            f"interlace {interlace} is not supported (8-bit grey/RGB/RGBA "
            "and 16-bit grey, non-interlaced)")
    channels = _COLOUR_TYPES[colour][0]
    bpp = channels * depth // 8
    pix = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp, bpp)
    if depth == 16:
        return pix.view(">u2").astype(np.uint16).reshape(height, width)
    return pix.reshape((height, width) if channels == 1
                       else (height, width, channels))


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """PNG bytes of [H, W] / [H, W, 3] / [H, W, 4] uint8 (grey, RGB, RGBA)
    or [H, W] uint16 (16-bit grey), every row unfiltered."""
    a = np.asarray(image)
    if a.dtype == np.uint16 and a.ndim == 2:
        depth, colour, data = 16, 0, a.astype(">u2")
    elif a.dtype == np.uint8 and (a.ndim == 2 or (
            a.ndim == 3 and a.shape[2] in (3, 4))):
        depth, colour = 8, 0 if a.ndim == 2 else {3: 2, 4: 6}[a.shape[2]]
        data = a
    else:
        raise ValueError(f"write_png: unsupported array {a.dtype} "
                         f"{a.shape}")
    height, width = a.shape[:2]
    rows = np.ascontiguousarray(data).view(np.uint8).reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth,
                                         colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


def write_png(path, image: np.ndarray, level: int = 6) -> None:
    """``encode_png`` to a file."""
    Path(path).write_bytes(encode_png(image, level))


def read_image(path) -> np.ndarray:
    """A PNG through ``read_png``, a JPEG through ``data/jpeg``; any other
    file raises naming it."""
    if is_png(path):
        return read_png(path)
    from .jpeg import is_jpeg, read_jpeg

    if is_jpeg(path):
        return read_jpeg(path)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")


def to_rgb(a: np.ndarray) -> np.ndarray:
    """PIL's ``convert("RGB")`` of an 8-bit grey, RGB or RGBA array."""
    if a.ndim == 2:
        return np.repeat(a[..., None], 3, axis=2)
    return a[..., :3]


def to_grey(a: np.ndarray) -> np.ndarray:
    """PIL's ``convert("L")`` of an 8-bit grey, RGB or RGBA array:
    (R·19595 + G·38470 + B·7471 + 2^15) >> 16."""
    if a.ndim == 2:
        return a
    c = a[..., :3].astype(np.uint32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


# Pillow's Resample.c: 8-bit coefficients carry 22 fraction bits.
_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Resample.c's ``bicubic_filter`` (a = -0.5), term for term."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coeffs(in_size: int, out_size: int):
    """Resample.c ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    box (0, in_size): per output index the first input index, the tap
    count and the int32 fixed-point weights ([out, ksize], zero past the
    taps)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    taps = np.arange(ksize)
    live = taps[None, :] < xmax[:, None]
    w = np.where(live, _bicubic((taps[None, :] + xmin[:, None] - center[:, None]
                                 + 0.5) * (1.0 / filterscale)), 0.0)
    # Sum tap by tap in order, as the C loop does.
    ww = np.zeros(out_size)
    for k in range(ksize):
        ww = ww + w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    fixed = w * (1 << _PRECISION_BITS)
    kk = np.trunc(np.where(w < 0, fixed - 0.5, fixed + 0.5)).astype(np.int64)
    return xmin, xmax, np.where(live, kk, 0)


def _resample_axis(a: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of ``ImagingResampleHorizontal/Vertical_8bpc`` along
    ``axis`` of a uint8 array: sum of taps in int64 from 2^21, clipped to
    uint8 after the shift."""
    a = np.moveaxis(a, axis, 0)
    xmin, xmax, kk = _coeffs(a.shape[0], out_size)
    idx = np.minimum(xmin[:, None] + np.arange(kk.shape[1])[None, :],
                     a.shape[0] - 1)
    acc = np.full((out_size,) + a.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    expand = (slice(None),) + (None,) * (a.ndim - 1)
    for k in range(kk.shape[1]):
        acc += a[idx[:, k]].astype(np.int64) * kk[:, k][expand]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(a: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """PIL's default ``Image.resize(size)`` (bicubic, ``ImagingResample``)
    of an 8-bit [H, W] or [H, W, C] array, bit for bit: a horizontal pass,
    then a vertical one, each rounded and clipped to uint8; the array
    itself when ``size`` (W, H) is its own."""
    w, h = size
    if (a.shape[1], a.shape[0]) == (w, h):
        return a
    if a.dtype != np.uint8:
        raise ValueError(f"resize_bicubic: {a.dtype} is not 8-bit")
    out = a
    if a.shape[1] != w:
        out = _resample_axis(out, w, 1)
    if a.shape[0] != h:
        out = _resample_axis(out, h, 0)
    return out


def resize_nearest(a: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """cv2.resize(a, size, interpolation=INTER_NEAREST) for size (W, H):
    output pixel (y, x) reads input (floor(y·h_in/h), floor(x·w_in/w)),
    each clamped to the last index."""
    w, h = size
    h_in, w_in = a.shape[:2]
    ys = np.minimum(np.floor(np.arange(h) * (h_in / h)).astype(np.int64),
                    h_in - 1)
    xs = np.minimum(np.floor(np.arange(w) * (w_in / w)).astype(np.int64),
                    w_in - 1)
    return a[ys[:, None], xs[None, :]]


def resize_nearest_pil(a: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """PIL's ``Image.resize(size, Image.NEAREST)`` (Geometry.c
    ``ImagingScaleAffine``): output x reads input int(x0 + x·s) with
    x0 = s/2, s = w_in/w, the positions summed step by step in float64 as
    the C loop sums them."""
    w, h = size
    h_in, w_in = a.shape[:2]

    def index(n_in: int, n_out: int) -> np.ndarray:
        s = n_in / n_out
        pos = np.add.accumulate(np.concatenate(
            [[s * 0.5], np.full(n_out - 1, s)]))
        return np.minimum(pos.astype(np.int64), n_in - 1)

    return a[index(h_in, h)[:, None], index(w_in, w)[None, :]]
