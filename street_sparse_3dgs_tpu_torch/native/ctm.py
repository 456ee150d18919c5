"""OpenCTM (RAW) mesh writer for the Cyclomedia depth-render pipeline.

``save_ctm`` writes an offset-centred OpenCTM v5 mesh through the host C++
writer ``hostsrc/ctm_exporter.cpp`` (a copy of the JAX package's
``native/ctm_exporter.cpp``, built at first use by ``native/host``; a failed
build raises).  ``save_ctm_plain`` is the same file written in Python, the
plain version the tests hold the native writer against; ``load_ctm`` reads
a RAW CTM back.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from . import host

_COMMENT = b"street_sparse_3dgs_tpu ctm_exporter"
_SIGNATURES = {
    "save_ctm": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double)]),
}


def _arrays(vertices, triangles, user_offset):
    verts = np.ascontiguousarray(vertices, np.float32)
    tris = np.ascontiguousarray(triangles, np.int32)
    off = np.ascontiguousarray(user_offset, np.float64)
    if verts.ndim != 2 or verts.shape[1] != 3:
        raise ValueError("vertices must be [n, 3]")
    if tris.ndim != 2 or tris.shape[1] != 3:
        raise ValueError("triangles must be [m, 3]")
    return verts, tris, off


def save_ctm(filename, vertices: np.ndarray, triangles: np.ndarray,
             user_offset=(0.0, 0.0, 0.0)) -> None:
    """Write an OpenCTM (RAW) mesh; vertices [n,3] f32, triangles [m,3] i32,
    ``user_offset`` subtracted from every vertex."""
    verts, tris, off = _arrays(vertices, triangles, user_offset)
    lib = host.load("ctm_exporter", _SIGNATURES)
    rc = lib.save_ctm(
        str(filename).encode(),
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), verts.shape[0],
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), tris.shape[0],
        off.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        raise IOError(f"save_ctm failed with code {rc}")


def save_ctm_plain(filename, vertices: np.ndarray, triangles: np.ndarray,
                   user_offset=(0.0, 0.0, 0.0)) -> None:
    """``save_ctm`` in Python: the same bytes."""
    verts, tris, off = _arrays(vertices, triangles, user_offset)
    with open(filename, "wb") as f:
        f.write(b"OCTM")
        f.write(struct.pack("<i", 5))
        f.write(b"RAW\x00")
        f.write(struct.pack("<iiiii", verts.shape[0], tris.shape[0], 0, 0,
                            0))
        f.write(struct.pack("<i", len(_COMMENT)))
        f.write(_COMMENT)
        f.write(b"INDX")
        f.write(tris.astype("<u4").tobytes())
        f.write(b"VERT")
        f.write((verts - off[None, :]).astype("<f4").tobytes())


def load_ctm(filename):
    """RAW-CTM reader: -> (verts [n,3] f32, tris [m,3] i32)."""
    with open(filename, "rb") as f:
        if f.read(4) != b"OCTM":
            raise ValueError(f"{filename}: not an OpenCTM file")
        f.read(4)                                   # version
        method = f.read(4)
        if method != b"RAW\x00":
            raise ValueError(f"unsupported CTM method {method!r}")
        nv, nt, _, _, _ = struct.unpack("<iiiii", f.read(20))
        (clen,) = struct.unpack("<i", f.read(4))
        f.read(clen)
        if f.read(4) != b"INDX":
            raise ValueError(f"{filename}: no INDX block")
        tris = np.frombuffer(f.read(12 * nt), "<u4").reshape(nt, 3)
        if f.read(4) != b"VERT":
            raise ValueError(f"{filename}: no VERT block")
        verts = np.frombuffer(f.read(12 * nv), "<f4").reshape(nv, 3)
    return verts.copy(), tris.astype(np.int32)
