"""The per-iteration training step (render -> loss -> grads -> update),
mirroring ``street_sparse_3dgs_tpu/train/step.py``: forward render,
photometric + depth losses, backward (K2 / K4 under ``method="pallas"``),
grad masking (locked skybox, coarse-stage skybox scales, depth-only
features), the masked sparse Adam step on rows whose opacity grad is
nonzero, the exposure Adam step, the scheduled learning rates, the
densification statistics and the optional big-Gaussian clamp.

PyTorch runs eagerly, so the step is a Python callable (``TrainStep``)
rather than a compiled program.  It makes no host sync: the step counter
``TrainState.step`` is a CPU scalar (the schedules and the SH warm-up read
it for free), every other state tensor lives on the parameters' device, and
the counts-mode revert selects with ``torch.where`` on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import OptimizationConfig, PipelineConfig
from ..core.camera import CameraParams
from ..core.schedules import expon_lr
from ..models import adam, densify
from ..models.gaussians import (GaussianMeta, GaussianParams,
                                activate_opacity, activate_scales,
                                apply_exposure, clamp_big_gaussians,
                                init_exposure, sh_coeffs)
from ..ops.rasterize import RasterConfig, rasterize
from . import losses


class TrainState(NamedTuple):
    params: GaussianParams
    active: torch.Tensor              # [C] bool
    adam_state: adam.AdamState
    exposure: torch.Tensor            # [n_images, 3, 4]
    exposure_adam: adam.DenseAdamState
    grad_accum: torch.Tensor          # [C] densify stats (max screen-grad norm)
    denom: torch.Tensor               # [C]
    max_radii2d: torch.Tensor         # [C]
    step: torch.Tensor                # int32 scalar ON THE CPU (1-based)


class CameraBatch(NamedTuple):
    """Everything one training view contributes."""

    camera: CameraParams
    gt_image: torch.Tensor            # [3, H, W]
    alpha_mask: torch.Tensor          # [1, H, W] (ones if absent)
    mono_invdepth: torch.Tensor       # [1, H, W] (zeros if absent)
    depth_mask: torch.Tensor          # [1, H, W]
    depth_reliable: torch.Tensor      # bool scalar
    image_index: torch.Tensor         # int scalar: exposure table row


def init_state(params: GaussianParams, active: torch.Tensor,
               n_images: int) -> TrainState:
    dev = params.xyz.device
    c = params.xyz.shape[0]

    def z():
        return torch.zeros((c,), dtype=torch.float32, device=dev)

    exposure = init_exposure(n_images, dev)
    return TrainState(params=params, active=active,
                      adam_state=adam.init(params), exposure=exposure,
                      exposure_adam=adam.dense_init(exposure),
                      grad_accum=z(), denom=z(), max_radii2d=z(),
                      step=torch.zeros((), dtype=torch.int32))


def raster_config(pipe: PipelineConfig) -> RasterConfig:
    if pipe.exact_extra < 0:
        raise ValueError(
            "exact_extra == -1 (self-sizing) must be resolved by the train "
            "loop's autosizer before building a step")
    return RasterConfig(method=pipe.raster_method, max_dup=pipe.max_dup,
                        tile_capacity=pipe.tile_capacity,
                        tiles_chunk=pipe.tiles_chunk,
                        exact_extra=pipe.exact_extra,
                        grad_sort=pipe.grad_sort,
                        grad_reduce=pipe.grad_reduce,
                        dup_overscan=pipe.dup_overscan,
                        dup_tails=tuple(pipe.dup_tails))


def _select(ok: torch.Tensor, new, old):
    """``where(ok, new, old)`` over a (nested) NamedTuple of tensors;
    ``None`` leaves stay ``None``."""
    if new is None:
        return None
    if isinstance(new, torch.Tensor):
        return torch.where(ok, new, old)
    return type(new)(*(_select(ok, a, b) for a, b in zip(new, old)))


class TrainStep:
    """One training mode's step (``make_train_step``).  Call it as
    ``step(state, batch, bg=None)`` -> (new_state, aux).  ``bg`` [3] is the
    background; without it a random one is drawn from the step's
    ``torch.Generator`` (``random_background``) or the fixed colour is
    used.  ``forward`` and ``value_and_grad`` expose the first two stages
    for timing them apart."""

    def __init__(self, meta: GaussianMeta, opt: OptimizationConfig,
                 pipe: PipelineConfig, spatial_lr_scale: float, *,
                 sh_degree_schedule: bool, is_depth_only: bool,
                 use_trained_exp: bool, optimize_xyz: bool,
                 additional_depth_maps_weight: float,
                 zero_scaling_grads_for_skybox: bool,
                 clamp_extent: float | None, clamp_fraction: float,
                 random_background: bool, white_background: bool,
                 background_seed: int,
                 bg_generator: torch.Generator | None):
        self.cfg = raster_config(pipe)
        self.meta, self.opt = meta, opt
        self.spatial_lr_scale = spatial_lr_scale
        self.sh_degree_schedule = sh_degree_schedule
        self.is_depth_only = is_depth_only
        self.use_exp = use_trained_exp and not is_depth_only
        self.optimize_xyz = optimize_xyz
        self.depth_maps_weight = additional_depth_maps_weight
        self.zero_sky_scales = zero_scaling_grads_for_skybox
        self.clamp_extent, self.clamp_fraction = clamp_extent, clamp_fraction
        self.random_background = random_background
        self.white_background = white_background
        self.background_seed = background_seed
        self.bg_generator = bg_generator

    # -- schedules --------------------------------------------------------
    def _lrs(self, it: int):
        opt = self.opt
        xyz_lr = float(expon_lr(it, opt.position_lr_init
                                * self.spatial_lr_scale,
                                opt.position_lr_final * self.spatial_lr_scale,
                                lr_delay_mult=opt.position_lr_delay_mult,
                                max_steps=opt.position_lr_max_steps))
        if not self.optimize_xyz:
            xyz_lr = 0.0
        exp_lr = float(expon_lr(it, opt.exposure_lr_init,
                                opt.exposure_lr_final,
                                lr_delay_steps=opt.exposure_lr_delay_steps,
                                lr_delay_mult=opt.exposure_lr_delay_mult,
                                max_steps=opt.iterations))
        depth_w = float(expon_lr(it, opt.depth_l1_weight_init,
                                 opt.depth_l1_weight_final,
                                 max_steps=opt.iterations))
        return xyz_lr, exp_lr, depth_w

    def active_sh(self, state: TrainState) -> int:
        """SH warm-up: +1 degree every 1000 steps up to the model's."""
        it = int(state.step)
        return min(it // 1000, self.meta.sh_degree) \
            if self.sh_degree_schedule else self.meta.sh_degree

    def background(self, device: torch.device) -> torch.Tensor:
        if not self.random_background:
            return torch.full((3,), 1.0 if self.white_background else 0.0,
                              device=device)
        if self.bg_generator is None:
            self.bg_generator = torch.Generator(device=device).manual_seed(
                self.background_seed)
        return torch.rand((3,), generator=self.bg_generator, device=device)

    # -- forward and grads -------------------------------------------------
    def forward(self, params: GaussianParams, exposure_row: torch.Tensor,
                mean2d_res: torch.Tensor, active: torch.Tensor,
                batch: CameraBatch, active_sh: int, depth_w: float,
                bg: torch.Tensor):
        """(loss, image, raster outputs) of one view."""
        out = rasterize(params.xyz, activate_scales(params), params.quats,
                        activate_opacity(params, self.meta),
                        sh_coeffs(params), batch.camera, active_sh, bg,
                        self.cfg, active_mask=active,
                        mean2d_residual=mean2d_res)
        image = out["render"]
        if self.use_exp:
            image = apply_exposure(image, exposure_row)
        image = torch.clamp(image, 0.0, 1.0)
        inv_depth = out["depth"]
        zero = torch.zeros((), device=image.device)
        pure = losses.depth_l1(inv_depth, batch.mono_invdepth,
                               batch.depth_mask)
        if self.is_depth_only:
            hinge = losses.depth_hinge(inv_depth, batch.mono_invdepth)
            w = self.depth_maps_weight
            loss = depth_w * (w * hinge + (1.0 - w) * pure)
            loss = torch.where(batch.depth_reliable, loss, zero)
        else:
            loss = losses.photometric(image * batch.alpha_mask,
                                      batch.gt_image, self.opt.lambda_dssim)
            loss = loss + torch.where(batch.depth_reliable, depth_w * pure,
                                      zero)
        return loss, image, out

    def value_and_grad(self, state: TrainState, batch: CameraBatch,
                       active_sh: int, depth_w: float, bg: torch.Tensor):
        """(loss, image, out, grads of params, exposure row, screen)."""
        params = GaussianParams(*(p.detach().requires_grad_(True)
                                  for p in state.params))
        exposure_row = state.exposure[batch.image_index].detach() \
            .requires_grad_(True)
        mean2d_res = torch.zeros((params.xyz.shape[0], 2),
                                 device=params.xyz.device,
                                 requires_grad=True)
        loss, image, out = self.forward(params, exposure_row, mean2d_res,
                                        state.active, batch, active_sh,
                                        depth_w, bg)
        inputs = (*params, exposure_row, mean2d_res)
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(inputs, grads)]
        return (loss.detach(), image.detach(), out,
                GaussianParams(*grads[:6]), grads[6], grads[7])

    # -- the step -----------------------------------------------------------
    def __call__(self, state: TrainState, batch: CameraBatch,
                 bg: torch.Tensor | None = None):
        meta = self.meta
        active_sh = self.active_sh(state)
        it = int(state.step) + 1
        xyz_lr, exp_lr, depth_w = self._lrs(it)
        dev = state.params.xyz.device
        if bg is None:
            bg = self.background(dev)
        loss, image, out, g_params, g_exposure_row, g_screen = \
            self.value_and_grad(state, batch, active_sh, depth_w, bg)

        with torch.no_grad():
            capacity = state.params.xyz.shape[0]
            rows = torch.arange(capacity, device=dev)
            if meta.skybox_locked and meta.skybox_points > 0:
                locked = rows < meta.skybox_points
                g_params = GaussianParams(*(torch.where(
                    locked.reshape((-1,) + (1,) * (g.dim() - 1)),
                    torch.zeros_like(g), g) for g in g_params))
            if self.zero_sky_scales and meta.skybox_points > 0:
                sky = (rows < meta.skybox_points)[:, None]
                g_params = g_params._replace(log_scales=torch.where(
                    sky, torch.zeros_like(g_params.log_scales),
                    g_params.log_scales))
            if self.is_depth_only:
                g_params = g_params._replace(
                    features_dc=torch.zeros_like(g_params.features_dc),
                    features_rest=torch.zeros_like(g_params.features_rest))

            # Sparse Adam on rows with a nonzero opacity grad.
            relevant = (g_params.opacity_raw[:, 0] != 0.0) & state.active
            opt = self.opt
            lrs = adam.ParamLrs.from_config(xyz_lr, opt.feature_lr,
                                            opt.opacity_lr, opt.scaling_lr,
                                            opt.rotation_lr)
            new_params, new_adam = adam.step(state.params, g_params,
                                             state.adam_state, lrs, relevant)

            # Exposure Adam, dense over the whole table.
            if self.use_exp:
                g_exp = torch.zeros_like(state.exposure)
                g_exp[batch.image_index] = g_exposure_row
                new_exposure, new_exp_adam = adam.dense_step(
                    state.exposure, g_exp, state.exposure_adam, exp_lr)
            else:
                new_exposure, new_exp_adam = (state.exposure,
                                              state.exposure_adam)

            # Densification statistics.
            visible = out["visibility"] & state.active
            stats = densify.add_stats(
                densify.DensifyState(state.grad_accum, state.denom,
                                     state.max_radii2d),
                g_screen, out["radii"].detach(), visible)

            if self.clamp_extent is not None:
                new_params = clamp_big_gaussians(
                    new_params, meta, self.clamp_extent, self.clamp_fraction,
                    state.active)

            step_t = torch.tensor(it, dtype=torch.int32)
            new_state = TrainState(
                params=new_params, active=state.active, adam_state=new_adam,
                exposure=new_exposure, exposure_adam=new_exp_adam,
                grad_accum=stats.grad_accum, denom=stats.denom,
                max_radii2d=stats.max_radii2d, step=step_t)
            aux = {"loss": loss, "image": image, "bg": bg,
                   "n_visible": torch.sum(visible),
                   "dup_overflow": out["dup_overflow"],
                   "tile_overflow": out["tile_overflow"]}
            if self.cfg.grad_reduce == "counts" and self.cfg.exact_extra:
                # The counts backward is sound only at tile_overflow == 0:
                # an overflowing step keeps the old state (the step counter
                # still advances) and reports update_skipped.
                ok = out["tile_overflow"] == 0
                new_state = _select(ok, new_state._replace(step=None),
                                    state._replace(step=None))
                new_state = new_state._replace(step=step_t)
                aux["update_skipped"] = (~ok).to(torch.int32)
        return new_state, aux


def make_train_step(
    meta: GaussianMeta,
    opt: OptimizationConfig,
    pipe: PipelineConfig,
    spatial_lr_scale: float,
    *,
    sh_degree_schedule: bool = True,
    is_depth_only: bool = False,
    use_trained_exp: bool = True,
    optimize_xyz: bool = True,
    additional_depth_maps_weight: float = 0.9,
    zero_scaling_grads_for_skybox: bool = False,
    clamp_extent: float | None = None,
    clamp_fraction: float = 0.02,
    random_background: bool = True,
    white_background: bool = False,
    background_seed: int = 17,
    bg_generator: torch.Generator | None = None,
) -> TrainStep:
    """Build the step for one training mode; the flags are those of the JAX
    ``make_train_step`` (see its docstring for the reference behaviours).
    The random background comes from ``bg_generator`` or, without one, a
    generator on the parameters' device seeded with ``background_seed``.

    Turns TF32 off for matmuls and cuDNN convolutions (the SSIM window):
    the JAX package runs them at full f32 precision."""
    losses.tf32_off()
    return TrainStep(
        meta, opt, pipe, spatial_lr_scale,
        sh_degree_schedule=sh_degree_schedule, is_depth_only=is_depth_only,
        use_trained_exp=use_trained_exp, optimize_xyz=optimize_xyz,
        additional_depth_maps_weight=additional_depth_maps_weight,
        zero_scaling_grads_for_skybox=zero_scaling_grads_for_skybox,
        clamp_extent=clamp_extent, clamp_fraction=clamp_fraction,
        random_background=random_background,
        white_background=white_background, background_seed=background_seed,
        bg_generator=bg_generator)
