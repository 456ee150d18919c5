"""Hierarchy serialization in the JAX package's ``.hier.npz`` format
(``street_sparse_3dgs_tpu/hierarchy/io.py``), byte-compatible both ways:

  xyz, features_dc, features_rest, log_scales, quats, opacity_raw
      — [n_rows, ...] raw params, abs-opacity convention, skybox tail last
  parent, child_start, child_count    — [n_nodes] int32 topology
  box_center, box_half, size          — [n_nodes] geometry / cut metric
  anchors                             — [n_nodes] bool frozen mask
  skybox_count                        — scalar int64
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..models.gaussians import GaussianParams
from .structure import Hierarchy

_PARAM_KEYS = GaussianParams._fields
_NODE_KEYS = ("parent", "child_start", "child_count", "box_center",
              "box_half", "size", "anchors")


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def save_hierarchy(path: str | Path, h: Hierarchy) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {k: _np(getattr(h.params, k)) for k in _PARAM_KEYS}
    arrays.update({k: _np(getattr(h, k)) for k in _NODE_KEYS})
    np.savez_compressed(path, **arrays, skybox_count=np.int64(h.skybox_count))


def load_hierarchy(path: str | Path,
                   device: str | torch.device = DEFAULT_DEVICE) -> Hierarchy:
    dev = resolve_device(device)
    with np.load(Path(path)) as z:
        def t(k):
            return torch.as_tensor(z[k], device=dev)

        return Hierarchy(
            params=GaussianParams(*(t(k) for k in _PARAM_KEYS)),
            **{k: t(k) for k in _NODE_KEYS},
            skybox_count=int(z["skybox_count"]),
        )
