"""JPEG without PIL: a baseline decoder and encoder in host C++
(``hostsrc/jpeg_codec.cpp``, built at first use by ``native/host``) and a
reader of the EXIF GPS tags.

- ``decode_jpeg`` / ``read_jpeg`` give what ``np.asarray(PIL.Image.open(p))``
  gives for a sequential Huffman JPEG of 8-bit samples, grey ([H, W]) or
  three components ([H, W, 3] RGB), sampled 4:4:4, 4:2:2 or 4:2:0, with or
  without restart intervals, at any size: libjpeg-turbo's accurate integer
  IDCT, fancy chroma upsampling and fixed-point YCbCr->RGB, bit for bit.
  Any other JPEG (progressive, arithmetic-coded, lossless, 12-bit, CMYK)
  raises ``ValueError`` naming the file and the reason.
- ``encode_jpeg`` / ``write_jpeg``: baseline, YCbCr 4:2:0 (PIL's default)
  or 4:4:4 (grey stays one component), the IJG quality-scaled standard
  tables.  Its bytes are not PIL's; its quality is
  (``tests/test_torch_image_io.py``).
- ``exif_gps`` reads GPS tags 1-4 from the APP1 EXIF segment as PIL's
  ``_getexif()[34853]`` gives them (references as strings, the degree
  triples as floats).
"""

from __future__ import annotations

import ctypes
import struct
from pathlib import Path

import numpy as np

from ..native import host

_U8P = ctypes.POINTER(ctypes.c_uint8)
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "jpeg_info": (ctypes.c_int, [_U8P, ctypes.c_int64, _IP, _IP, _IP,
                                 ctypes.c_char_p, ctypes.c_int]),
    "jpeg_decode": (ctypes.c_int, [_U8P, ctypes.c_int64, _U8P,
                                   ctypes.c_char_p, ctypes.c_int]),
    "jpeg_encode": (ctypes.c_int64, [_U8P, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, _U8P, ctypes.c_int64]),
}
_ERR_LEN = 256


def _lib():
    return host.load("jpeg_codec", _SIGNATURES)


def is_jpeg(path) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\xff\xd8"


def decode_jpeg(data: bytes, name="<bytes>") -> np.ndarray:
    """[H, W] or [H, W, 3] uint8 from JPEG bytes; ``name`` goes into the
    error message."""
    lib = _lib()
    buf = np.frombuffer(data, np.uint8)
    ptr = buf.ctypes.data_as(_U8P)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.jpeg_info(ptr, buf.size, ctypes.byref(w), ctypes.byref(h),
                     ctypes.byref(c), err, _ERR_LEN) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, 3)
    out = np.empty(shape, np.uint8)
    if lib.jpeg_decode(ptr, buf.size, out.ctypes.data_as(_U8P), err,
                       _ERR_LEN) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def read_jpeg(path) -> np.ndarray:
    return decode_jpeg(Path(path).read_bytes(), str(path))


def encode_jpeg(image: np.ndarray, quality: int = 85,
                subsampling: str = "4:2:0") -> bytes:
    """Baseline JPEG bytes of [H, W] / [H, W, 3] uint8 at IJG ``quality``,
    chroma ``subsampling`` "4:2:0" (PIL's default) or "4:4:4"."""
    if subsampling not in ("4:2:0", "4:4:4"):
        raise ValueError(f"encode_jpeg: subsampling {subsampling!r} is not "
                         "4:2:0 or 4:4:4")
    a = np.ascontiguousarray(image)
    if a.dtype != np.uint8 or not (a.ndim == 2 or (a.ndim == 3
                                                   and a.shape[2] == 3)):
        raise ValueError(f"encode_jpeg: unsupported array {a.dtype} "
                         f"{a.shape}")
    h, w = a.shape[:2]
    c = 1 if a.ndim == 2 else 3
    cap = h * w * c + 4096
    while True:
        out = np.empty(cap, np.uint8)
        n = _lib().jpeg_encode(a.ctypes.data_as(_U8P), w, h, c,
                               int(quality), int(subsampling == "4:2:0"),
                               out.ctypes.data_as(_U8P), cap)
        if n == 0:
            raise ValueError(f"encode_jpeg: cannot encode a {w}x{h} image")
        if n > 0:
            return out[:n].tobytes()
        cap = -n


def write_jpeg(path, image: np.ndarray, quality: int = 85,
               subsampling: str = "4:2:0") -> None:
    Path(path).write_bytes(encode_jpeg(image, quality, subsampling))


# ---------------------------------------------------------------- EXIF GPS

_GPS_IFD = 0x8825
_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 7: 1, 9: 4, 10: 8}


def _app1_exif(data: bytes):
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker in (0xD9, 0xDA):
            return None
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + length]
        if marker == 0xE1 and body[:6] == b"Exif\0\0":
            return body[6:]
        pos += 2 + length
    return None


def _ifd(tiff: bytes, offset: int, order: str) -> dict:
    (n,) = struct.unpack(order + "H", tiff[offset:offset + 2])
    out = {}
    for i in range(n):
        e = offset + 2 + 12 * i
        tag, kind, count = struct.unpack(order + "HHI", tiff[e:e + 8])
        size = _TYPE_SIZE.get(kind)
        if size is None:
            continue
        raw = tiff[e + 8:e + 12]
        if size * count > 4:
            (off,) = struct.unpack(order + "I", raw)
            raw = tiff[off:off + size * count]
        else:
            raw = raw[:size * count]
        if kind == 2:
            out[tag] = raw.split(b"\0", 1)[0].decode("ascii", "replace")
        elif kind in (5, 10):
            f = order + ("I" if kind == 5 else "i") * (2 * count)
            v = struct.unpack(f, raw)
            out[tag] = tuple(v[2 * k] / v[2 * k + 1] if v[2 * k + 1]
                             else float("nan") for k in range(count))
        elif kind in (3, 4, 9):
            f = order + {3: "H", 4: "I", 9: "i"}[kind] * count
            v = struct.unpack(f, raw)
            out[tag] = v[0] if count == 1 else v
        else:
            out[tag] = raw
    return out


def exif_gps(path) -> dict:
    """GPS tags 1-4 of a JPEG's EXIF ({} without any): {1: 'N', 2: (deg,
    min, sec), 3: 'E', 4: (deg, min, sec)}, the tags present only."""
    data = Path(path).read_bytes()
    if data[:2] != b"\xff\xd8":
        return {}
    tiff = _app1_exif(data)
    if tiff is None or tiff[:2] not in (b"II", b"MM"):
        return {}
    order = "<" if tiff[:2] == b"II" else ">"
    (first,) = struct.unpack(order + "I", tiff[4:8])
    ifd0 = _ifd(tiff, first, order)
    if _GPS_IFD not in ifd0:
        return {}
    gps = _ifd(tiff, int(ifd0[_GPS_IFD]), order)
    return {k: v for k, v in gps.items() if k in (1, 2, 3, 4)}
