"""Build, load and count the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface (one ``nvcc`` per source, all started together)
and loaded with ``ctypes``.  A kernel's entry point is ``<name>_launch`` in
``csrc/<name>.cu``, or in the source ``SOURCES`` names for it.  The build runs at first use on a machine with
``nvcc``; the library name carries a hash of every source and flag, so
editing a kernel rebuilds it.  Libraries land in ``build/kernels/`` at the
repository root, which ``.gitignore`` lists.

Every C entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()``; ``check`` raises on a nonzero code.
``LAUNCHES`` counts, per kernel, the launches its wrapper made.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("blend_padded", "blend_exact", "slab_gather", "blend_padded_bwd",
           "blend_exact_bwd", "blend_exact_stub", "bin_scan", "project_fwd",
           "project_bwd")
# Kernels whose entry point lives in a source of another name.
SOURCES = {"project_fwd": "project", "project_bwd": "project"}
# No --use_fast_math (expf/log1pf stay the accurate versions) and no FMA
# contraction (-fmad=false): every product rounds on its own, as in the
# plain PyTorch versions, so a slot whose alpha sits on the 1/255 skip
# threshold is skipped or kept by both alike.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

LAUNCHES = {name: 0 for name in KERNELS}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_ARGTYPES = {
    # attrs, counts, bg, bg_per_tile, T, K, tiles_x, tile0, t_mod, out, stream
    "blend_padded": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    # attrs, vcounts, wt, last_v, order (or null), tiles, bg, K, group,
    # tiles_x, t_mod, table, len(table), pass2, combine, len(pass2) =
    # len(combine), drop, part, out, stream
    "blend_exact": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P, _I, _P,
                    _P, _I, _P, _P, _P, _P],
    # vals, starts, counts, T, K, rank_mask, sentinel, out, stream
    "slab_gather": [_P, _P, _P, _I, _I, _LL, _I, _P, _P],
    # attrs, counts, bg, bg_per_tile, T, K, tiles_x, tile0, t_mod, saved,
    # g_out, d_attrs, stream
    "blend_padded_bwd": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # attrs, vcounts, wt, last_v, order, bg, len(order), K, tiles_x, t_mod,
    # saved, g_out, d_attrs, stream
    "blend_exact_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                        _P],
    # attrs, vcounts, wt, last_v, bg, T, K, tiles_x, level, pair_major,
    # tiles_per_block, group, table, len(table), pass2, combine,
    # len(pass2) = len(combine), drop, part, out, stream
    "blend_exact_stub": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                         _I, _P, _P, _I, _P, _P, _P, _P],
    # mean2d, conic, radius, valid, qcap, N, tiles_x, tiles_y, scan, kept,
    # coverage, tile_id, stream
    "bin_scan": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    # means, scales, quats, opacities, sh, mask (or null), view, proj,
    # campos, tan_fovx, tan_fovy, focal_x, focal_y, N, K, degree, width,
    # height, scale_modifier, mean2d, depth, inv_depth, conic, radius,
    # color, opacity, valid, stream
    "project_fwd": [_P] * 13 + [_I] * 5 + [_F] + [_P] * 9,
    # means, scales, quats, sh, mask (or null), view, proj, campos,
    # tan_fovx, tan_fovy, focal_x, focal_y, N, K, degree, width, height,
    # scale_modifier, the cotangents of mean2d, depth, inv_depth, conic,
    # color and opacity (each or null), the gradients of means, scales,
    # quats, opacities and sh (each or null), stream
    "project_bwd": [_P] * 12 + [_I] * 5 + [_F] + [_P] * 12,
}
_fns: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    """The library of kernel ``name``'s source."""
    return BUILD_DIR / f"lib{SOURCES.get(name, name)}-{_digest()}.so"


def build() -> dict:
    """Compile every kernel whose library is missing, one ``nvcc`` per
    source in parallel.  Returns {"seconds", "built", "ptxas"} where
    ``ptxas`` maps each built kernel to its register, spill and
    shared-memory report.
    Raises with the compiler's output if any build fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in dict.fromkeys(SOURCES.get(k, k) for k in KERNELS):
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    ptxas = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln
                       or "Compiling entry" in ln]
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {"seconds": time.perf_counter() - t0, "built": sorted(procs),
            "ptxas": ptxas}


def launcher(name: str):
    """The C entry point ``<name>_launch`` of kernel ``name``, its library
    built first if missing and loaded once."""
    fn = _fns.get(name)
    if fn is None:
        path = library_path(name)
        if not path.exists():
            build()
        fn = getattr(ctypes.CDLL(str(path)), f"{name}_launch")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` on PyTorch's current CUDA stream, raise if the
    launch was refused, and count it.  The stream is read as a raw handle
    (``torch.cuda.current_stream()`` builds a Python object per call, a
    host cost that a few-microsecond kernel would feel)."""
    import torch

    stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
    rc = launcher(name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
    LAUNCHES[name] += 1
