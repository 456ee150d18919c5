"""PLY IO for point clouds and 3DGS Gaussian attribute dumps, mirroring
``street_sparse_3dgs_tpu/data/ply.py`` byte for byte: a self-contained
binary-little-endian reader/writer (no ``plyfile``) for the reference's two
layouts,

- point clouds: x, y, z[, nx, ny, nz], red, green, blue (``storePly`` /
  ``fetchPly``, ``scene/dataset_readers.py:220-249``);
- Gaussian models: x, y, z, nx, ny, nz, f_dc_0..2, f_rest_*, opacity,
  scale_0..2, rot_0..3 (``scene/gaussian_model.py:459-471``), f_rest stored
  channel-major (all coefficients of R, then G, then B).

The files are numpy on the host; ``save_gaussian_ply`` takes the port's
parameters (tensors on any device) and ``load_gaussian_ply`` returns them
on ``device``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..models.gaussians import GaussianParams

_DTYPES = {"float": "<f4", "double": "<f8", "uchar": "u1", "uint8": "u1",
           "int": "<i4", "uint": "<u4", "short": "<i2", "ushort": "<u2",
           "char": "i1"}


def read_ply(path) -> dict[str, np.ndarray]:
    """Read the first ('vertex') element into {property: column} arrays.
    Supports binary_little_endian and ascii."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n_vertex = 0
        props = []
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                if name == "vertex":
                    n_vertex = int(cnt)
                elif props:
                    break  # only the vertex element is read
            elif line.startswith("property") and n_vertex:
                parts = line.split()
                if parts[1] == "list":
                    raise ValueError("list properties unsupported")
                props.append((parts[2], _DTYPES[parts[1]]))
            elif line == "end_header":
                break
        dtype = np.dtype(props)
        if fmt == "binary_little_endian":
            data = np.frombuffer(f.read(dtype.itemsize * n_vertex),
                                 dtype=dtype)
        elif fmt == "ascii":
            rows = [f.readline().split() for _ in range(n_vertex)]
            data = np.array([tuple(r) for r in rows], dtype=dtype)
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    return {name: np.ascontiguousarray(data[name]) for name, _ in props}


def write_ply(path, columns: dict[str, np.ndarray]) -> None:
    """Write a binary_little_endian vertex-only PLY from named columns
    (uint8 columns as uchar, every other as float)."""
    n = len(next(iter(columns.values())))
    props = []
    arrays = []
    cols = {}
    for name, col in columns.items():
        col = np.asarray(col)
        if col.dtype == np.uint8:
            props.append(f"property uchar {name}")
            arrays.append((name, "u1"))
        else:
            col = col.astype(np.float32)
            props.append(f"property float {name}")
            arrays.append((name, "<f4"))
        cols[name] = col
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n}\n" + "\n".join(props) + "\nend_header\n")
    rec = np.empty(n, dtype=np.dtype(arrays))
    for name, _ in arrays:
        rec[name] = cols[name]
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


# ---------------------------------------------------------------------------
# Point clouds


def store_point_cloud(path, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """xyz float, rgb uint8 [N, 3] -> ply with zero normals (reference
    ``storePly``)."""
    write_ply(path, {
        "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
        "nx": np.zeros(len(xyz)), "ny": np.zeros(len(xyz)),
        "nz": np.zeros(len(xyz)),
        "red": rgb[:, 0].astype(np.uint8),
        "green": rgb[:, 1].astype(np.uint8),
        "blue": rgb[:, 2].astype(np.uint8)})


def fetch_point_cloud(path) -> tuple[np.ndarray, np.ndarray]:
    """-> (xyz [N, 3] float32, colors [N, 3] float32 in [0, 1])."""
    cols = read_ply(path)
    xyz = np.stack([cols["x"], cols["y"], cols["z"]], -1).astype(np.float32)
    if "red" in cols:
        rgb = np.stack([cols["red"], cols["green"], cols["blue"]],
                       -1).astype(np.float32)
        if rgb.max() > 1.0:
            rgb = rgb / 255.0
    else:
        rgb = np.full_like(xyz, 0.5)
    return xyz, rgb


# ---------------------------------------------------------------------------
# Gaussian models


def params_to_numpy(params: GaussianParams,
                    active: torch.Tensor | np.ndarray | None = None
                    ) -> GaussianParams:
    """The parameter tensors as host numpy arrays, the ``active`` rows
    only when given."""
    p = GaussianParams(*(np.asarray(x.detach().cpu())
                         if isinstance(x, torch.Tensor) else np.asarray(x)
                         for x in params))
    if active is not None:
        if isinstance(active, torch.Tensor):
            active = active.cpu()
        idx = np.nonzero(np.asarray(active))[0]
        p = GaussianParams(*(x[idx] for x in p))
    return p


def save_gaussian_ply(path, params: GaussianParams,
                      active: torch.Tensor | np.ndarray | None = None
                      ) -> None:
    p = params_to_numpy(params, active)
    n = p.xyz.shape[0]
    cols = {"x": p.xyz[:, 0], "y": p.xyz[:, 1], "z": p.xyz[:, 2],
            "nx": np.zeros(n), "ny": np.zeros(n), "nz": np.zeros(n)}
    for i in range(3):
        cols[f"f_dc_{i}"] = p.features_dc[:, 0, i]
    k_rest = p.features_rest.shape[1]
    # channel-major flatten (torch transpose(1,2) order)
    fr = p.features_rest.transpose(0, 2, 1).reshape(n, 3 * k_rest)
    for i in range(3 * k_rest):
        cols[f"f_rest_{i}"] = fr[:, i]
    cols["opacity"] = p.opacity_raw[:, 0]
    for i in range(3):
        cols[f"scale_{i}"] = p.log_scales[:, i]
    for i in range(4):
        cols[f"rot_{i}"] = p.quats[:, i]
    write_ply(path, cols)


def load_gaussian_ply(path, device: str | torch.device = DEFAULT_DEVICE
                      ) -> GaussianParams:
    dev = resolve_device(device)
    cols = read_ply(path)
    n = len(cols["x"])
    xyz = np.stack([cols["x"], cols["y"], cols["z"]], -1)
    f_dc = np.stack([cols[f"f_dc_{i}"] for i in range(3)], -1)[:, None, :]
    n_rest = len([k for k in cols if k.startswith("f_rest_")])
    k_rest = n_rest // 3
    if n_rest:
        fr = np.stack([cols[f"f_rest_{i}"] for i in range(n_rest)], -1)
        f_rest = fr.reshape(n, 3, k_rest).transpose(0, 2, 1)
    else:
        f_rest = np.zeros((n, 0, 3), np.float32)
    log_scales = np.stack([cols[f"scale_{i}"] for i in range(3)], -1)
    quats = np.stack([cols[f"rot_{i}"] for i in range(4)], -1)
    opacity = cols["opacity"][:, None]

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=dev)

    return GaussianParams(xyz=t(xyz), features_dc=t(f_dc),
                          features_rest=t(f_rest), log_scales=t(log_scales),
                          quats=t(quats), opacity_raw=t(opacity))
