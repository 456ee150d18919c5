"""Hierarchy post-optimization — the ``train_post.py`` equivalent, mirroring
``street_sparse_3dgs_tpu/train/post.py``.

Reference semantics (``train_post.py:31-198``):
  - per step, a random granularity limit ~ logU[0.005, 0.1] (``:66-74``);
  - ``expand_to_size`` + ``get_interpolation_weights`` pick the cut;
  - ``render_post`` lerps child/parent and rasterizes; photometric loss only;
  - grads flow through the lerp to BOTH child and parent rows;
  - skybox tail rows (when locked) and anchor nodes get their grads zeroed
    (``:167-181``);
  - dense ``torch.optim.Adam`` step (``our_adam=False``, eps 1e-15), exposure
    pre-trained from the chunk stage (looked up, not optimized).

The cut is the vectorized mask form (``hierarchy/structure.py``); the dense
Adam is the masked sparse Adam with an all-rows mask.  The step is a Python
callable that makes no host sync; its counter ``PostTrainState.step`` is a
CPU scalar, as ``TrainState.step`` is.  ``CompactPostDriver`` runs the
O(cut) compacted form with a capacity that grows on overflow.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import OptimizationConfig, PipelineConfig
from ..core.schedules import expon_lr
from ..hierarchy.render import render_cut, render_cut_compacted
from ..hierarchy.structure import Hierarchy, select_cut
from ..models import adam
from ..models.gaussians import GaussianParams, apply_exposure
from . import losses
from .step import CameraBatch, raster_config

LIMIT_MIN = 0.005
LIMIT_MAX = 0.1


class PostTrainState(NamedTuple):
    params: GaussianParams           # hierarchy rows (abs-opacity convention)
    adam_state: adam.AdamState
    step: torch.Tensor               # int32 scalar ON THE CPU


def init_post_state(h: Hierarchy) -> PostTrainState:
    return PostTrainState(params=h.params, adam_state=adam.init(h.params),
                          step=torch.zeros((), dtype=torch.int32))


def random_limit(rng) -> float:
    """limit = 2^(u·(log2 max − log2 min) + log2 min) (``train_post.py:
    66-74``); host-side python RNG like the reference's torch.rand, so both
    packages draw the same limits from the same ``random.Random``."""
    u = rng.random()
    return math.pow(2, u * (math.log2(LIMIT_MAX) - math.log2(LIMIT_MIN))
                    + math.log2(LIMIT_MIN))


def default_post_capacity(h: Hierarchy, campos_list,
                          limit: float = LIMIT_MIN) -> int:
    """Initial compact-cut capacity: sample the FINEST-granularity cut at a
    few camera positions and pad 1.5x to the next power of two (a bounded
    set of shapes under growth)."""
    dev = h.parent.device
    worst = 0
    for campos in list(campos_list)[:8]:
        campos = torch.as_tensor(np.array(campos, np.float32), device=dev)
        cut = select_cut(h, campos, limit)
        worst = max(worst, int(torch.sum(cut.selected)))
    need = int(worst * 1.5) + 64
    return 1 << max(6, (need - 1).bit_length())


class PostStep:
    """One post-opt step (``make_post_step``): call it as
    ``step(state, batch, limit, exposure_row)`` -> (new_state, aux)."""

    def __init__(self, h: Hierarchy, opt: OptimizationConfig,
                 pipe: PipelineConfig, *, skybox_locked: bool,
                 use_trained_exp: bool, white_background: bool,
                 compact_capacity: int | None):
        dev = h.params.xyz.device
        self.cfg = raster_config(pipe)
        self.opt = opt
        self.use_trained_exp = use_trained_exp
        self.compact_capacity = compact_capacity
        self.bg = torch.full((3,), 1.0 if white_background else 0.0,
                             device=dev)
        self.n_nodes, self.skybox_count = h.n_nodes, h.skybox_count
        total = h.n_rows
        self.sh_degree = int(math.isqrt(h.params.features_rest.shape[1]
                                        + 1)) - 1
        # Topology only (it never changes during post-opt).
        self.topo = h._replace(params=None)
        frozen = torch.cat([h.anchors, torch.zeros(
            total - self.n_nodes, dtype=torch.bool, device=dev)])
        if skybox_locked and self.skybox_count > 0:
            frozen = frozen | (torch.arange(total, device=dev)
                               >= total - self.skybox_count)
        self.frozen_rows = frozen
        self.all_rows = torch.ones(total, dtype=torch.bool, device=dev)

    def loss(self, params: GaussianParams, batch: CameraBatch, cut,
             exposure_row: torch.Tensor):
        """(loss, image, cut_overflow) of one view."""
        if self.compact_capacity is not None:
            out = render_cut_compacted(params, cut, self.n_nodes,
                                       self.skybox_count,
                                       self.compact_capacity, batch.camera,
                                       self.sh_degree, self.bg, self.cfg)
        else:
            out = render_cut(params, cut, self.n_nodes, self.skybox_count,
                             batch.camera, self.sh_degree, self.bg, self.cfg)
        image = out["render"]
        if self.use_trained_exp:
            image = apply_exposure(image, exposure_row)
        image = torch.clamp(image, 0.0, 1.0)
        loss = losses.photometric(image * batch.alpha_mask, batch.gt_image,
                                  self.opt.lambda_dssim)
        overflow = out.get("cut_overflow")
        if overflow is None:
            overflow = torch.zeros((), dtype=torch.int64, device=image.device)
        return loss, image, overflow

    def __call__(self, state: PostTrainState, batch: CameraBatch, limit,
                 exposure_row: torch.Tensor):
        opt = self.opt
        it = int(state.step) + 1
        cut = select_cut(self.topo, batch.camera.campos, float(limit))
        params = GaussianParams(*(p.detach().requires_grad_(True)
                                  for p in state.params))
        loss, image, cut_overflow = self.loss(params, batch, cut,
                                              exposure_row)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            g_params = GaussianParams(*(torch.where(
                self.frozen_rows.reshape((-1,) + (1,) * (g.dim() - 1)),
                torch.zeros_like(g), g) for g in grads))
            xyz_lr = float(expon_lr(
                it, opt.position_lr_init, opt.position_lr_final,
                lr_delay_mult=opt.position_lr_delay_mult,
                max_steps=opt.position_lr_max_steps))
            lrs = adam.ParamLrs.from_config(xyz_lr, opt.feature_lr,
                                            opt.opacity_lr, opt.scaling_lr,
                                            opt.rotation_lr)
            # Dense Adam (reference: our_adam=False) == masked Adam, all
            # rows on.
            new_params, new_adam = adam.step(state.params, g_params,
                                             state.adam_state, lrs,
                                             self.all_rows)
        new_state = PostTrainState(params=new_params, adam_state=new_adam,
                                   step=torch.tensor(it, dtype=torch.int32))
        return new_state, {"loss": loss.detach(), "image": image.detach(),
                           "n_selected": torch.sum(cut.selected),
                           "cut_overflow": cut_overflow}


def make_post_step(
    h: Hierarchy,
    opt: OptimizationConfig,
    pipe: PipelineConfig,
    *,
    skybox_locked: bool = True,
    use_trained_exp: bool = True,
    white_background: bool = False,
    compact_capacity: int | None = None,
) -> PostStep:
    """Returns ``(state, batch, limit, exposure_row) -> (state, aux)``.

    Post-opt renders against the *fixed* white/black background — unlike the
    coarse/single stages it does not randomize per step (``train_post.py:
    42-43,123``).

    ``compact_capacity`` switches the render from the O(nodes) mask form to
    the O(cut) compacted form (``hierarchy/render.blend_cut_compact``): only
    the selected rows (+ skybox tail) are gathered, lerped and rasterized.
    The aux ``cut_overflow`` counts selected nodes beyond capacity — the
    driver must grow the capacity and REDO the step when it is nonzero.

    Turns TF32 off for matmuls and cuDNN convolutions (the SSIM window), as
    ``make_train_step`` does."""
    losses.tf32_off()
    return PostStep(h, opt, pipe, skybox_locked=skybox_locked,
                    use_trained_exp=use_trained_exp,
                    white_background=white_background,
                    compact_capacity=compact_capacity)


class CompactPostDriver:
    """Host driver for the O(cut) compacted post-opt step with static-shape
    capacity growth.

    The step is dispatched with a one-step lag: step t's ``cut_overflow`` is
    read right before dispatching t+1.  On overflow the capacity is grown to
    the next power of two that fits and step t REDONE from its pre-step
    state — no work is ever silently dropped.  The step returns new tensors,
    so holding the pre-step state keeps one copy of the parameters and both
    Adam moments alive, and nothing is cloned."""

    def __init__(self, h: Hierarchy, opt: OptimizationConfig,
                 pipe: PipelineConfig, capacity: int, **step_kwargs):
        self._h = h
        self._opt = opt
        self._pipe = pipe
        self._kwargs = step_kwargs
        self.capacity = int(capacity)
        self.state = init_post_state(h)
        self.redos = 0
        self._pending = None          # (pre-step state, args, aux)
        self._make()

    def _make(self):
        self._step = make_post_step(self._h, self._opt, self._pipe,
                                    compact_capacity=self.capacity,
                                    **self._kwargs)

    def _resolve(self):
        prev, args, aux = self._pending
        self._pending = None
        ovf = int(aux["cut_overflow"])
        while ovf > 0:
            need = self.capacity + ovf
            self.capacity = 1 << (need - 1).bit_length()
            self._make()
            self.redos += 1
            self.state, aux = self._step(prev, *args)
            ovf = int(aux["cut_overflow"])
        return aux

    def step(self, batch: CameraBatch, limit, exposure_row):
        """Run one post-opt step; returns the PREVIOUS step's resolved aux
        (None on the first call).  Call ``finish()`` after the loop."""
        out = self._resolve() if self._pending is not None else None
        prev = self.state
        args = (batch, limit, exposure_row)
        self.state, aux = self._step(prev, *args)
        self._pending = (prev, args, aux)
        return out

    def finish(self) -> PostTrainState:
        """Resolve the in-flight step and return the final state."""
        if self._pending is not None:
            self._resolve()
        return self.state
