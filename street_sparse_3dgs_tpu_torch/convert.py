"""Carry weights, cameras and hierarchies across from the JAX package.

Each converter takes the JAX object's fields as numpy arrays — as
``{k: np.asarray(v) for k, v in x._asdict().items()}`` gives them — and
returns the port's object on ``device``.  ``to_numpy`` goes the other way,
so a round trip returns the same arrays.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .core.camera import CameraParams
from .device import DEFAULT_DEVICE, resolve_device
from .hierarchy.structure import Hierarchy
from .models.gaussians import GaussianParams

_CAMERA_TENSORS = CameraParams._fields[:7]
_HIER_NODE_KEYS = ("parent", "child_start", "child_count", "box_center",
                   "box_half", "size", "anchors")


def _tensor(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=dev)


def _fields(x) -> Mapping:
    return x._asdict() if hasattr(x, "_asdict") else x


def params_from_numpy(fields: Mapping,
                      device: str | torch.device = DEFAULT_DEVICE
                      ) -> GaussianParams:
    dev = resolve_device(device)
    fields = _fields(fields)
    return GaussianParams(*(_tensor(fields[k], dev)
                            for k in GaussianParams._fields))


def camera_from_numpy(fields: Mapping,
                      device: str | torch.device = DEFAULT_DEVICE
                      ) -> CameraParams:
    dev = resolve_device(device)
    fields = _fields(fields)
    return CameraParams(*(_tensor(fields[k], dev) for k in _CAMERA_TENSORS),
                        height=int(fields["height"]),
                        width=int(fields["width"]))


def hierarchy_from_numpy(fields: Mapping,
                         device: str | torch.device = DEFAULT_DEVICE
                         ) -> Hierarchy:
    """``fields["params"]`` may be a mapping of the six parameter arrays or
    the parameter tuple itself."""
    fields = _fields(fields)
    params = params_from_numpy(_fields(fields["params"]), device)
    dev = params.xyz.device
    return Hierarchy(params=params,
                     **{k: _tensor(fields[k], dev) for k in _HIER_NODE_KEYS},
                     skybox_count=int(fields["skybox_count"]))


def to_numpy(x) -> dict:
    """A port ``NamedTuple`` as {field: numpy array or int}, recursively."""
    out = {}
    for k, v in x._asdict().items():
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().cpu().numpy()
        elif hasattr(v, "_asdict"):
            out[k] = to_numpy(v)
        else:
            out[k] = v
    return out
