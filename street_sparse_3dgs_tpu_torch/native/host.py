"""Build and load the host C++ libraries in ``hostsrc/``.

Each ``hostsrc/<name>.cpp`` (the JPEG codec, the LAZ codec, the CTM
writer) is compiled by ``g++ -O2 -shared -fPIC`` at first use into
``build/host/lib<name>-<hash>.so`` at the repository root (``build/`` is
ignored by git) and loaded with ``ctypes``.  The hash covers the source
and the flags, so editing a source rebuilds it.  A failed build raises
with the compiler's output: there is no other path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

HOSTSRC = Path(__file__).resolve().parent.parent / "hostsrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_libs: dict = {}
_lock = threading.Lock()


def library_path(name: str) -> Path:
    src = HOSTSRC / f"{name}.cpp"
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``hostsrc/<name>.cpp`` unless its library exists."""
    out = library_path(name)
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(f"cannot build {name}: no C++ compiler (g++) "
                           "on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(HOSTSRC / f"{name}.cpp"),
                           "-o", str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for hostsrc/{name}.cpp:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The library of ``hostsrc/<name>.cpp``, built first if missing, with
    ``signatures`` ({function: (restype, [argtypes])}) applied once."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, (restype, argtypes) in signatures.items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = argtypes
            _libs[name] = lib
    return lib
