"""Typed configuration tree and its reflection-based CLI, field for field
those of ``street_sparse_3dgs_tpu/config.py``: the same names and defaults,
the same ``--field`` flags (types matched by the string annotations that
``from __future__ import annotations`` leaves on the fields), and the same
``<model_path>/cfg_args`` JSON snapshot, so a snapshot written by one
package loads in the other.  ``raster_method="pallas"`` selects the CUDA
kernels here."""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path


@dataclasses.dataclass
class ModelConfig:
    """Dataset / scene-loading parameters (reference ``ModelParams``)."""

    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    exp_name: str = ""
    images: str = "images"
    alpha_masks: str = ""
    depths: str = ""
    resolution: int = -1
    white_background: bool = False
    train_test_exp: bool = False
    eval: bool = False
    skip_scale_big_gauss: bool = False
    hierarchy: str = ""
    pretrained: str = ""
    skybox_num: int = 0
    scaffold_file: str = ""
    bounds_file: str = ""
    skybox_locked: bool = False
    additional_depth_maps: bool = False
    gt_point_cloud_constraints: bool = False
    constraint_treshold: float = 0.05   # (sic — reference spelling)
    additional_depth_maps_weight: float = 0.9


@dataclasses.dataclass
class PipelineConfig:
    """Renderer knobs.  ``raster_method="pallas"`` selects the CUDA kernels;
    ``exact_extra`` > 0 is exact (virtual-tile) mode, 0 padded mode, and -1
    self-sizing exact mode (the train loop measures the knobs with
    ``ops/autosize.py``)."""

    debug: bool = False
    raster_method: str = "tiled"     # "tiled" | "oracle" | "pallas"
    max_dup: int = 64
    tile_capacity: int = 512
    tiles_chunk: int = 16
    exact_extra: int = 0
    dup_overscan: int = 0
    dup_tails: tuple = ()
    grad_sort: str = "f32"           # "f32" | "bf16"
    grad_reduce: str = "sort"        # "sort" | "counts" (exact mode only)


@dataclasses.dataclass
class OptimizationConfig:
    """Training hyperparameters (reference ``OptimizationParams`` defaults)."""

    iterations: int = 30_000
    position_lr_init: float = 0.00002
    position_lr_final: float = 0.0000002
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    exposure_lr_init: float = 0.001
    exposure_lr_final: float = 0.0001
    exposure_lr_delay_steps: int = 5000
    exposure_lr_delay_mult: float = 0.001
    percent_dense: float = 0.0001
    lambda_dssim: float = 0.2
    densification_interval: int = 300
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.015
    depth_l1_weight_init: float = 1.0
    depth_l1_weight_final: float = 0.01


def parse_tails(s) -> tuple:
    """``"budget:width,budget:width"`` -> ``((budget, width), ...)``
    (already-parsed tuples/lists pass through; '' -> ())."""
    if not s:
        return ()
    if isinstance(s, (tuple, list)):
        return tuple((int(b), int(w)) for b, w in s)
    return tuple(tuple(int(x) for x in part.split(":"))
                 for part in s.split(",") if part)


_GROUPS = {"model": ModelConfig, "pipeline": PipelineConfig,
           "opt": OptimizationConfig}


def add_group_args(parser: argparse.ArgumentParser, cls) -> None:
    """Auto-create ``--field`` flags from dataclass fields (bools become
    store_true, mirroring ParamGroup's reflection)."""
    for f in dataclasses.fields(cls):
        name = "--" + f.name
        if f.type in ("bool", bool):
            parser.add_argument(name, action="store_true",
                                default=f.default)
        elif f.type in ("tuple", tuple):
            default = f.default if f.default is not dataclasses.MISSING \
                else f.default_factory()
            parser.add_argument(name, type=parse_tails, default=default)
        else:
            typ = {"int": int, "float": float, "str": str}.get(f.type, str) \
                if isinstance(f.type, str) else f.type
            parser.add_argument(name, type=typ, default=f.default)


def extract_group(args: argparse.Namespace, cls):
    kw = {}
    for f in dataclasses.fields(cls):
        if not hasattr(args, f.name):
            continue
        v = getattr(args, f.name)
        if f.type in ("tuple", tuple):
            v = parse_tails(v)          # JSON round-trips tuples as lists
        kw[f.name] = v
    return cls(**kw)


def make_parser(description: str = "") -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    for cls in _GROUPS.values():
        add_group_args(parser, cls)
    return parser


def parse_all(argv=None, description: str = ""):
    parser = make_parser(description)
    args, _ = parser.parse_known_args(argv)
    return (extract_group(args, ModelConfig),
            extract_group(args, PipelineConfig),
            extract_group(args, OptimizationConfig), args)


def save_cfg_args(model_path: str | Path, model: ModelConfig,
                  pipeline: PipelineConfig, opt: OptimizationConfig) -> None:
    """Snapshot the full config as JSON in ``<model_path>/cfg_args``."""
    path = Path(model_path)
    path.mkdir(parents=True, exist_ok=True)
    blob = {name: dataclasses.asdict(cfg) for name, cfg in
            (("model", model), ("pipeline", pipeline), ("opt", opt))}
    (path / "cfg_args").write_text(json.dumps(blob, indent=2))


def load_combined(model_path: str | Path, argv=None):
    """Merge a saved cfg_args with CLI flags; CLI wins where explicitly given
    (``get_combined_args`` semantics)."""
    blob = json.loads((Path(model_path) / "cfg_args").read_text())
    parser = make_parser()
    args, _ = parser.parse_known_args(argv or [])
    explicit = set()
    for tok in (argv or []):
        if tok.startswith("--"):
            explicit.add(tok[2:].split("=")[0])
    out = []
    for name, cls in _GROUPS.items():
        saved = blob.get(name, {})
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name in explicit:
                kw[f.name] = getattr(args, f.name)
            elif f.name in saved:
                kw[f.name] = saved[f.name]
            else:
                kw[f.name] = f.default
            if f.type in ("tuple", tuple):
                kw[f.name] = parse_tails(kw[f.name])
        out.append(cls(**kw))
    return tuple(out)
