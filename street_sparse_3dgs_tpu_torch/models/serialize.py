"""Stage artifacts and in-loop checkpoints, mirroring
``street_sparse_3dgs_tpu/models/serialize.py``:

- the reference's stage artifact set (``scene/__init__.py:95-115``):
  ``point_cloud/iteration_N/point_cloud.ply`` (``data/ply.py``), the packed
  ``point_cloud.bin`` above ``PACKED_BIN_THRESHOLD`` rows, ``pc_info.txt``
  (skybox count), ``scaffold_info.txt`` and ``exposure.json``;
- a single-file ``.npz`` checkpoint of the whole ``TrainState`` (params,
  active mask, Adam moments, exposure and its moments, densify statistics,
  step) and the ``GaussianMeta``.  The keys and dtypes are the JAX
  package's, so a checkpoint written by either package loads in the other
  bit for bit and training resumes exactly.

Files are written from host numpy copies; loads put the tensors on
``device`` (the state's ``step`` stays a CPU scalar, where the port's step
reads it).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..train.step import TrainState
from . import adam
from .gaussians import GaussianMeta, GaussianParams

# Above this many points the reference switches to the packed-binary fast
# path (scene/__init__.py:103-105); both formats are written there.
PACKED_BIN_THRESHOLD = 8_000_000


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def save_packed_bin(path: str | Path, params: GaussianParams,
                    active: torch.Tensor | np.ndarray | None = None) -> None:
    """Write the reference's ``point_cloud.bin`` fast format
    (``scene/gaussian_model.py:473-506``): int32 count, then contiguous f32
    blocks xyz [N, 3], SH features [N, K, 3] (DC band first), opacity
    [N, 1], log-scales [N, 3], rotations [N, 4]."""
    from ..data.ply import params_to_numpy

    p = params_to_numpy(params, active)
    n = p.xyz.shape[0]
    feats = np.concatenate([p.features_dc, p.features_rest], axis=1)
    with open(path, "wb") as f:
        f.write(np.int32(n).tobytes())
        for arr in (p.xyz, feats, p.opacity_raw, p.log_scales, p.quats):
            f.write(np.ascontiguousarray(arr, np.float32).tobytes())


def load_packed_bin(path: str | Path,
                    device: str | torch.device = DEFAULT_DEVICE
                    ) -> GaussianParams:
    """Read ``point_cloud.bin``; the SH band count is inferred from the
    record size (the format does not store it), and a body that does not
    factor as n * (11 + 3K) floats is refused as corrupt."""
    dev = resolve_device(device)
    raw = Path(path).read_bytes()
    n = int(np.frombuffer(raw, np.int32, 1)[0])
    body = np.frombuffer(raw, np.float32, offset=4)
    if n == 0:
        k = 16
    else:
        per_row, rem = divmod(body.size, n)
        k, krem = divmod(per_row - 11, 3)   # 3 + 3K + 1 + 3 + 4 per row
        if rem or krem or k < 1 or body.size != n * (11 + 3 * k):
            raise ValueError(
                f"{path}: corrupt point_cloud.bin — {body.size} floats do "
                f"not factor as n*(11+3K) for n={n}")
    sizes = [3 * n, 3 * k * n, n, 3 * n, 4 * n]
    off, parts = 0, []
    for s in sizes:
        parts.append(body[off:off + s])
        off += s
    feats = parts[1].reshape(n, k, 3)

    def t(x):
        return torch.as_tensor(np.array(x), device=dev)    # a writable copy

    return GaussianParams(
        xyz=t(parts[0].reshape(n, 3)), features_dc=t(feats[:, :1]),
        features_rest=t(feats[:, 1:]), log_scales=t(parts[3].reshape(n, 3)),
        quats=t(parts[4].reshape(n, 4)), opacity_raw=t(parts[2].reshape(n, 1)))


def save_scene(model_path: str | Path, iteration: int, state: TrainState,
               meta: GaussianMeta, image_names: list[str]) -> Path:
    """Write the stage artifact set; returns the point_cloud directory."""
    from ..data.ply import save_gaussian_ply

    out = Path(model_path) / "point_cloud" / f"iteration_{iteration}"
    out.mkdir(parents=True, exist_ok=True)
    active = _np(state.active)
    if int(active.sum()) > PACKED_BIN_THRESHOLD:
        save_packed_bin(out / "point_cloud.bin", state.params, active)
    save_gaussian_ply(out / "point_cloud.ply", state.params, active)
    (out / "pc_info.txt").write_text(f"{meta.skybox_points}\n")
    (out / "scaffold_info.txt").write_text(f"{meta.scaffold_points}\n")
    exposure = _np(state.exposure)
    (Path(model_path) / "exposure.json").write_text(json.dumps(
        {name: exposure[i].tolist() for i, name in enumerate(image_names)}))
    return out


def load_scene_ply(point_cloud_dir: str | Path,
                   device: str | torch.device = DEFAULT_DEVICE):
    """Load (params, skybox_points) back from a stage artifact
    directory."""
    from ..data.ply import load_gaussian_ply

    d = Path(point_cloud_dir)
    if (d / "point_cloud.ply").exists():
        params = load_gaussian_ply(d / "point_cloud.ply", device)
    else:
        params = load_packed_bin(d / "point_cloud.bin", device)
    info = d / "pc_info.txt"
    skybox = int(info.read_text().split()[0]) if info.exists() else 0
    return params, skybox


def save_checkpoint(path: str | Path, state: TrainState, meta: GaussianMeta,
                    iteration: int) -> None:
    """The whole training state at ``iteration`` into a compressed
    ``.npz`` (the JAX package's keys and dtypes)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    blob = {"iteration": np.int64(iteration),
            "meta": json.dumps(dataclasses.asdict(meta)),
            "active": _np(state.active),
            "exposure": _np(state.exposure),
            "exp_mu": _np(state.exposure_adam.mu),
            "exp_nu": _np(state.exposure_adam.nu),
            "exp_step": _np(state.exposure_adam.step),
            "grad_accum": _np(state.grad_accum),
            "denom": _np(state.denom),
            "max_radii2d": _np(state.max_radii2d),
            "step": _np(state.step),
            "adam_step": _np(state.adam_state.step)}
    for name in GaussianParams._fields:
        blob[f"p_{name}"] = _np(getattr(state.params, name))
        blob[f"mu_{name}"] = _np(getattr(state.adam_state.mu, name))
        blob[f"nu_{name}"] = _np(getattr(state.adam_state.nu, name))
    np.savez_compressed(path, **blob)


def load_checkpoint(path: str | Path,
                    device: str | torch.device = DEFAULT_DEVICE
                    ) -> tuple[TrainState, GaussianMeta, int]:
    """(state on ``device``, meta, iteration) of a checkpoint written by
    either package."""
    dev = resolve_device(device)
    with np.load(Path(path), allow_pickle=False) as z:
        meta = GaussianMeta(**json.loads(str(z["meta"])))

        def t(key):
            return torch.as_tensor(z[key], device=dev)

        def params_of(prefix):
            return GaussianParams(*(t(f"{prefix}_{n}")
                                    for n in GaussianParams._fields))

        state = TrainState(
            params=params_of("p"), active=t("active"),
            adam_state=adam.AdamState(mu=params_of("mu"), nu=params_of("nu"),
                                      step=t("adam_step")),
            exposure=t("exposure"),
            exposure_adam=adam.DenseAdamState(t("exp_mu"), t("exp_nu"),
                                              t("exp_step")),
            grad_accum=t("grad_accum"), denom=t("denom"),
            max_radii2d=t("max_radii2d"),
            step=torch.as_tensor(z["step"]))
        return state, meta, int(z["iteration"])
