"""Configuration dataclasses, field for field those of
``street_sparse_3dgs_tpu/config.py`` (same names and defaults, so a JAX
config converts with ``dataclasses.asdict``).  The argparse helpers and the
``cfg_args`` snapshot belong to the CLI slice of the port."""

from __future__ import annotations

import dataclasses


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
