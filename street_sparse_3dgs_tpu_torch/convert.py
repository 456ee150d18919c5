"""Carry weights, cameras, hierarchies, training state and configs across
from the JAX package.

Each converter takes the JAX object's fields as numpy arrays — as
``{k: np.asarray(v) for k, v in x._asdict().items()}`` gives them, nested
objects as nested mappings (or the objects themselves) — and returns the
port's object on ``device``.  ``to_numpy`` goes the other way, so a round
trip returns the same arrays.  The configuration dataclasses convert field
by field (``config_from``).  ``TrainState.step`` stays on the CPU, where
the port's step reads it.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from .core.camera import CameraParams
from .device import DEFAULT_DEVICE, resolve_device
from .hierarchy.structure import Hierarchy
from .models import adam
from .models.gaussians import GaussianParams
from .train.step import CameraBatch, TrainState

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


def train_state_from_numpy(fields: Mapping,
                           device: str | torch.device = DEFAULT_DEVICE
                           ) -> TrainState:
    """A JAX ``TrainState``: params, active, adam_state (mu, nu, step),
    exposure and its dense Adam state, grad_accum, denom, max_radii2d and
    step."""
    dev = resolve_device(device)
    f = _fields(fields)
    a, e = _fields(f["adam_state"]), _fields(f["exposure_adam"])
    t = lambda x: _tensor(x, dev)
    return TrainState(
        params=params_from_numpy(_fields(f["params"]), dev),
        active=t(f["active"]),
        adam_state=adam.AdamState(
            mu=params_from_numpy(_fields(a["mu"]), dev),
            nu=params_from_numpy(_fields(a["nu"]), dev), step=t(a["step"])),
        exposure=t(f["exposure"]),
        exposure_adam=adam.DenseAdamState(t(e["mu"]), t(e["nu"]),
                                          t(e["step"])),
        grad_accum=t(f["grad_accum"]), denom=t(f["denom"]),
        max_radii2d=t(f["max_radii2d"]),
        step=torch.as_tensor(np.array(f["step"])))


def camera_batch_from_numpy(fields: Mapping,
                            device: str | torch.device = DEFAULT_DEVICE
                            ) -> CameraBatch:
    """A JAX ``CameraBatch`` (its camera as a nested mapping or object)."""
    dev = resolve_device(device)
    f = _fields(fields)
    return CameraBatch(camera=camera_from_numpy(_fields(f["camera"]), dev),
                       **{k: _tensor(f[k], dev)
                          for k in CameraBatch._fields[1:]})


def config_from(cfg, cls):
    """A JAX configuration dataclass (``GaussianMeta``, ``ModelConfig``,
    ``PipelineConfig``, ``OptimizationConfig``, ``RasterConfig``) as the
    port's class ``cls`` of the same fields."""
    return cls(**dataclasses.asdict(cfg))


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
