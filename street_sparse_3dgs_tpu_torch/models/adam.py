"""Masked sparse Adam, mirroring ``street_sparse_3dgs_tpu/models/adam.py``
(the reference's ``OurAdam``): only the rows listed in ``relevant`` move,
the moments of the other rows do not decay, and the bias-correction step is
global.  Written as plain functions on tensors, not ``torch.optim``, so the
state keeps the JAX layout (moments as ``GaussianParams``, a step scalar)
and carries across with ``convert.train_state_from_numpy``.

The update is the masked dense form ``where(relevant, adam(p), p)``: every
row streams once per step.  The step counter lives on the parameters'
device, so a reverted step (``train.step``) needs no host sync."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..profiling import span
from .gaussians import GaussianParams

BETA1 = 0.9
BETA2 = 0.999
EPS = 1e-15          # reference: Adam(l, lr=0.0, eps=1e-15)
EXPOSURE_EPS = 1e-8  # torch.optim.Adam default used for the exposure group


class AdamState(NamedTuple):
    mu: GaussianParams       # first moments
    nu: GaussianParams       # second moments
    step: torch.Tensor       # int32 scalar, global step (bias correction)


def init(params: GaussianParams) -> AdamState:
    zeros = GaussianParams(*(torch.zeros_like(p) for p in params))
    return AdamState(mu=zeros, nu=GaussianParams(*(torch.zeros_like(p)
                                                   for p in params)),
                     step=torch.zeros((), dtype=torch.int32,
                                      device=params.xyz.device))


class ParamLrs(NamedTuple):
    """Per-group learning rates (the xyz one is scheduled per step)."""

    xyz: torch.Tensor | float
    features_dc: torch.Tensor | float
    features_rest: torch.Tensor | float
    log_scales: torch.Tensor | float
    quats: torch.Tensor | float
    opacity_raw: torch.Tensor | float

    @staticmethod
    def from_config(xyz_lr, feature_lr, opacity_lr, scaling_lr, rotation_lr):
        """Group wiring of the reference's ``training_setup``
        (f_rest = feature_lr / 20)."""
        return ParamLrs(xyz=xyz_lr, features_dc=feature_lr,
                        features_rest=feature_lr / 20.0,
                        log_scales=scaling_lr, quats=rotation_lr,
                        opacity_raw=opacity_lr)


def _bias_corrections(t: torch.Tensor):
    tf = t.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=t.device)
    return (1.0 - torch.pow(one * BETA1, tf),
            1.0 - torch.pow(one * BETA2, tf))


def _rows(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (ndim - 1))


def step(params: GaussianParams, grads: GaussianParams, state: AdamState,
         lrs: ParamLrs, relevant: torch.Tensor,
         eps: float = EPS) -> tuple[GaussianParams, AdamState]:
    """One masked Adam step over the rows where ``relevant`` [C] is set."""
    with span("adam.sparse"):
        t = state.step + 1
        bc1, bc2 = _bias_corrections(t)
        new_p, new_m, new_v = [], [], []
        for p, g, m, v, lr in zip(params, grads, state.mu, state.nu, lrs):
            mask = _rows(relevant, p.dim())
            m_new = torch.where(mask, BETA1 * m + (1.0 - BETA1) * g, m)
            v_new = torch.where(mask, BETA2 * v + (1.0 - BETA2) * g * g, v)
            denom = torch.sqrt(v_new / bc2) + eps
            new_p.append(torch.where(mask, p - lr * (m_new / bc1) / denom,
                                     p))
            new_m.append(m_new)
            new_v.append(v_new)
    return (GaussianParams(*new_p),
            AdamState(mu=GaussianParams(*new_m), nu=GaussianParams(*new_v),
                      step=t))


class DenseAdamState(NamedTuple):
    mu: torch.Tensor
    nu: torch.Tensor
    step: torch.Tensor


def dense_init(param: torch.Tensor) -> DenseAdamState:
    return DenseAdamState(torch.zeros_like(param), torch.zeros_like(param),
                          torch.zeros((), dtype=torch.int32,
                                      device=param.device))


def dense_step(param: torch.Tensor, grad: torch.Tensor,
               state: DenseAdamState, lr, eps: float = EXPOSURE_EPS):
    """Plain Adam over the whole tensor (the exposure table)."""
    with span("adam.dense"):
        t = state.step + 1
        bc1, bc2 = _bias_corrections(t)
        m = BETA1 * state.mu + (1.0 - BETA1) * grad
        v = BETA2 * state.nu + (1.0 - BETA2) * grad * grad
        new = param - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
    return new, DenseAdamState(m, v, t)


def scatter_zero_rows(state: AdamState, rows_mask: torch.Tensor) -> AdamState:
    """Zero the moments of the given rows (new Gaussians enter the
    optimizer with zeroed moments)."""
    def zero(leaf):
        return torch.where(_rows(rows_mask, leaf.dim()),
                           torch.zeros_like(leaf), leaf)

    return AdamState(mu=GaussianParams(*(zero(x) for x in state.mu)),
                     nu=GaussianParams(*(zero(x) for x in state.nu)),
                     step=state.step)
