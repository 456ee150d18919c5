"""Self-contained LAS/LAZ point-cloud IO (no laspy dependency).

The reference chunker reads LiDAR tiles with ``laspy``
(``preprocess/ss_make_chunk.py:36-235``: x/y/z plus red/green/blue when
present).  This module reads the same files natively: LAS headers/VLRs are
parsed here with ``struct``/numpy, and LASzip chunk decompression runs in
the C++ codec (``hostsrc/laz_codec.cpp``, a copy of the JAX package's
``native/laz_codec.cpp`` built by ``native/host``) through ctypes — point
formats 0-3 (POINT10 / +GPSTIME11 / +RGB12, LASzip v2 coders).  A writer is
included so the codec is roundtrip-testable and chunk artifacts can be
exported as ``.laz``.

API: :func:`read_points(path)` → dict of numpy arrays (``x/y/z`` scaled
float64, ``red/green/blue`` u16 when present, ``intensity``,
``classification``); :func:`write_points(path, xyz, rgb=..., ...)` writes
``.las`` (raw) or ``.laz`` (compressed) by extension.
"""

from __future__ import annotations

import ctypes
import struct
from pathlib import Path

import numpy as np

from ..native import host

HEADER_12 = 227
VLR_HEADER = 54
LASZIP_RECORD_ID = 22204
ITEM_POINT10, ITEM_GPSTIME11, ITEM_RGB12 = 6, 7, 8
DEFAULT_CHUNK = 50_000

_POINT10 = [("X", "<i4"), ("Y", "<i4"), ("Z", "<i4"),
            ("intensity", "<u2"), ("bits", "u1"), ("classification", "u1"),
            ("scan_angle", "i1"), ("user_data", "u1"),
            ("point_source", "<u2")]
_GPS = [("gps_time", "<f8")]
_RGB = [("red", "<u2"), ("green", "<u2"), ("blue", "<u2")]


def point_dtype(fmt: int) -> np.dtype:
    fields = list(_POINT10)
    if fmt in (1, 3):
        fields += _GPS
    if fmt in (2, 3):
        fields += _RGB
    return np.dtype(fields)


_U8P = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    "laz_decode_chunk": (ctypes.c_int, [_U8P, ctypes.c_int64, ctypes.c_uint32,
                                        ctypes.c_int, ctypes.c_int, _U8P]),
    "laz_encode_chunk": (ctypes.c_int64, [_U8P, ctypes.c_uint32, ctypes.c_int,
                                          ctypes.c_int, _U8P,
                                          ctypes.c_int64]),
    "laz_decode_chunk_table": (ctypes.c_int, [
        _U8P, ctypes.c_int64, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint32)]),
    "laz_encode_chunk_table": (ctypes.c_int64, [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32, _U8P,
        ctypes.c_int64]),
}


def _load():
    """The LAZ codec's library, built at first use; raises if it cannot be
    built (``.las`` needs no codec)."""
    return host.load("laz_codec", _SIGNATURES)


def _u8ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class LasHeader:
    def __init__(self, data: bytes):
        if data[:4] != b"LASF":
            raise ValueError("not a LAS/LAZ file (missing LASF signature)")
        self.version = (data[24], data[25])
        (self.header_size, self.offset_to_points, self.n_vlrs) = \
            struct.unpack_from("<HII", data, 94)
        self.point_format_raw = data[104]
        self.compressed = bool(self.point_format_raw & 0x80)
        self.point_format = self.point_format_raw & 0x3F
        (self.record_length,) = struct.unpack_from("<H", data, 105)
        (self.n_points,) = struct.unpack_from("<I", data, 107)
        self.scale = np.array(struct.unpack_from("<3d", data, 131))
        self.offset = np.array(struct.unpack_from("<3d", data, 155))
        if self.n_points == 0 and self.version >= (1, 4) and len(data) >= 255:
            (self.n_points,) = struct.unpack_from("<Q", data, 247)


def _parse_vlrs(data: bytes, header: LasHeader):
    vlrs = []
    pos = header.header_size
    for _ in range(header.n_vlrs):
        user_id = data[pos + 2:pos + 18].split(b"\0")[0].decode("ascii",
                                                                "replace")
        record_id, length = struct.unpack_from("<HH", data, pos + 18)
        payload = data[pos + VLR_HEADER:pos + VLR_HEADER + length]
        vlrs.append((user_id, record_id, payload))
        pos += VLR_HEADER + length
    return vlrs


def _parse_laszip_vlr(payload: bytes):
    compressor, _coder = struct.unpack_from("<HH", payload, 0)
    chunk_size = struct.unpack_from("<I", payload, 12)[0]
    num_items = struct.unpack_from("<H", payload, 32)[0]
    items = [struct.unpack_from("<HHH", payload, 34 + 6 * i)
             for i in range(num_items)]
    return compressor, chunk_size, items


def read_points(path: str | Path) -> dict[str, np.ndarray]:
    """Read a ``.las`` or ``.laz`` file into numpy arrays (x/y/z scaled)."""
    data = Path(path).read_bytes()
    header = LasHeader(data)
    dtype = point_dtype(header.point_format)
    if header.point_format > 3:
        raise ValueError(
            f"point format {header.point_format} unsupported (0-3 only)")
    n = header.n_points
    if not header.compressed:
        raw = np.frombuffer(
            data, dtype=dtype, count=n, offset=header.offset_to_points)
        return _to_fields(raw, header)

    vlrs = _parse_vlrs(data, header)
    laszip = next((p for u, r, p in vlrs
                   if u == "laszip encoded" or r == LASZIP_RECORD_ID), None)
    if laszip is None:
        raise ValueError(f"{path}: compressed flag set but no LASzip VLR")
    compressor, chunk_size, items = _parse_laszip_vlr(laszip)
    if compressor != 2:
        raise ValueError(
            f"{path}: LASzip compressor {compressor} unsupported "
            "(only pointwise-chunked v2)")
    types = [t for t, _, _ in items]
    have_gps = int(ITEM_GPSTIME11 in types)
    have_rgb = int(ITEM_RGB12 in types)
    psize = 20 + 8 * have_gps + 6 * have_rgb
    if psize != dtype.itemsize:
        raise ValueError(f"{path}: item list {types} does not match point "
                         f"format {header.point_format}")

    lib = _load()
    (table_off,) = struct.unpack_from("<q", data, header.offset_to_points)
    first_chunk = header.offset_to_points + 8
    n_chunks = (n + chunk_size - 1) // chunk_size
    # chunk table: u32 version, u32 number_chunks, compressed sizes
    tab_n = struct.unpack_from("<I", data, table_off + 4)[0]
    if tab_n != n_chunks:
        raise ValueError(f"{path}: chunk table has {tab_n} entries, "
                         f"expected {n_chunks}")
    sizes = np.zeros(n_chunks, np.uint32)
    tab = np.frombuffer(data, np.uint8,
                        count=len(data) - table_off - 8,
                        offset=table_off + 8).copy()
    lib.laz_decode_chunk_table(
        _u8ptr(tab), tab.size, n_chunks,
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))

    out = np.zeros(n * psize, np.uint8)
    pos = first_chunk
    done = 0
    buf = np.frombuffer(data, np.uint8).copy()
    for ci in range(n_chunks):
        npts = min(chunk_size, n - done)
        end = pos + int(sizes[ci])
        rc = lib.laz_decode_chunk(
            _u8ptr(buf[pos:]), end - pos, npts, have_gps, have_rgb,
            _u8ptr(out[done * psize:]))
        if rc != 0:
            raise ValueError(f"{path}: chunk {ci} failed to decode")
        pos = end
        done += npts
    raw = out.view(dtype)
    return _to_fields(raw, header)


def _to_fields(raw: np.ndarray, header: LasHeader) -> dict[str, np.ndarray]:
    out = {
        "x": raw["X"] * header.scale[0] + header.offset[0],
        "y": raw["Y"] * header.scale[1] + header.offset[1],
        "z": raw["Z"] * header.scale[2] + header.offset[2],
        "intensity": np.asarray(raw["intensity"]),
        "classification": np.asarray(raw["classification"]),
        "point_format": header.point_format,
    }
    for k in ("red", "green", "blue", "gps_time"):
        if k in (raw.dtype.names or ()):
            out[k] = np.asarray(raw[k])
    return out


def write_points(path: str | Path, xyz: np.ndarray,
                 rgb: np.ndarray | None = None,
                 gps_time: np.ndarray | None = None,
                 intensity: np.ndarray | None = None,
                 classification: np.ndarray | None = None,
                 scale: float | np.ndarray = 0.001,
                 chunk_size: int = DEFAULT_CHUNK) -> Path:
    """Write ``.las`` (uncompressed) or ``.laz`` (LASzip chunked v2) by
    file extension.  ``rgb`` is u16 (u8 inputs are upscaled ×257 like
    laspy's convention)."""
    path = Path(path)
    xyz = np.asarray(xyz, np.float64)
    n = len(xyz)
    fmt = (1 if gps_time is not None and rgb is None else
           3 if gps_time is not None else
           2 if rgb is not None else 0)
    dtype = point_dtype(fmt)
    scale = np.broadcast_to(np.asarray(scale, np.float64), (3,))
    offset = xyz.min(axis=0) if n else np.zeros(3)
    raw = np.zeros(n, dtype)
    ixyz = np.round((xyz - offset) / scale).astype(np.int64)
    raw["X"], raw["Y"], raw["Z"] = (ixyz[:, 0].astype(np.int32),
                                    ixyz[:, 1].astype(np.int32),
                                    ixyz[:, 2].astype(np.int32))
    raw["bits"] = 0b001_001  # return 1 of 1
    if intensity is not None:
        raw["intensity"] = intensity
    if classification is not None:
        raw["classification"] = classification
    if rgb is not None:
        rgb = np.asarray(rgb)
        if rgb.dtype == np.uint8:
            rgb = rgb.astype(np.uint16) * 257
        raw["red"], raw["green"], raw["blue"] = (rgb[:, 0], rgb[:, 1],
                                                 rgb[:, 2])
    if gps_time is not None:
        raw["gps_time"] = gps_time

    compressed = path.suffix.lower() == ".laz"
    header = bytearray(HEADER_12)
    header[0:4] = b"LASF"
    header[24], header[25] = 1, 2
    struct.pack_into("<H", header, 90, 1)                      # day
    struct.pack_into("<H", header, 92, 2026)                   # year
    struct.pack_into("<H", header, 94, HEADER_12)
    fmt_byte = fmt | (0x80 if compressed else 0)
    header[104] = fmt_byte
    struct.pack_into("<H", header, 105, dtype.itemsize)
    struct.pack_into("<I", header, 107, n)
    struct.pack_into("<3d", header, 131, *scale)
    struct.pack_into("<3d", header, 155, *offset)
    mx, mn = (xyz.max(axis=0), xyz.min(axis=0)) if n else (np.zeros(3),) * 2
    struct.pack_into("<6d", header, 179, mx[0], mn[0], mx[1], mn[1],
                     mx[2], mn[2])

    if not compressed:
        struct.pack_into("<I", header, 96, HEADER_12)
        struct.pack_into("<I", header, 100, 0)
        path.write_bytes(bytes(header) + raw.tobytes())
        return path

    lib = _load()
    have_gps = int(fmt in (1, 3))
    have_rgb = int(fmt in (2, 3))
    items = [(ITEM_POINT10, 20, 2)]
    if have_gps:
        items.append((ITEM_GPSTIME11, 8, 2))
    if have_rgb:
        items.append((ITEM_RGB12, 6, 2))
    payload = struct.pack("<HHBBHIIqqH", 2, 0, 2, 2, 0, 0, chunk_size,
                          0, -1, len(items))
    for t, s, v in items:
        payload += struct.pack("<HHH", t, s, v)
    vlr = struct.pack("<H16sHH32s", 0, b"laszip encoded",
                      LASZIP_RECORD_ID, len(payload),
                      b"street_sparse_3dgs_tpu laz writer")
    offset_to_points = HEADER_12 + len(vlr) + len(payload)
    struct.pack_into("<I", header, 96, offset_to_points)
    struct.pack_into("<I", header, 100, 1)

    raw_bytes = np.frombuffer(raw.tobytes(), np.uint8).copy()
    psize = dtype.itemsize
    chunks = []
    sizes = []
    for start in range(0, max(n, 1), chunk_size):
        npts = min(chunk_size, n - start)
        if npts <= 0:
            break
        cap = npts * psize + 1024
        out = np.zeros(cap, np.uint8)
        sz = lib.laz_encode_chunk(
            _u8ptr(raw_bytes[start * psize:]), npts, have_gps, have_rgb,
            _u8ptr(out), cap)
        if sz < 0:
            raise RuntimeError("laz_encode_chunk overflow")
        chunks.append(out[:sz].tobytes())
        sizes.append(sz)

    sizes_arr = np.asarray(sizes, np.uint32)
    tab_cap = 16 * len(sizes) + 1024
    tab = np.zeros(tab_cap, np.uint8)
    tab_sz = lib.laz_encode_chunk_table(
        sizes_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(sizes), _u8ptr(tab), tab_cap)
    body = b"".join(chunks)
    table_off = offset_to_points + 8 + len(body)
    blob = (bytes(header) + vlr + payload +
            struct.pack("<q", table_off) + body +
            struct.pack("<II", 0, len(sizes)) + tab[:tab_sz].tobytes())
    path.write_bytes(blob)
    return path
