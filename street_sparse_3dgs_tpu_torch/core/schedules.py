"""Learning-rate schedules, mirroring
``street_sparse_3dgs_tpu/core/schedules.py``."""

from __future__ import annotations

import math

import torch


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0,
             max_steps: int = 1_000_000) -> torch.Tensor:
    """Log-linear interpolated lr with an optional sine-eased delayed warm
    start (the reference's ``get_expon_lr_func``), in float32 like the JAX
    function.  ``step`` is a number or a tensor; the result is a float32
    tensor on ``step``'s device (the CPU for a number).  0 when
    ``lr_init == 0`` or ``step < 0``."""
    step = torch.as_tensor(step).to(torch.float32)
    if lr_init == 0.0:
        return torch.zeros_like(step)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1.0 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0))
    else:
        delay_rate = 1.0
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=step.device)
    log_lerp = torch.exp(torch.log(f32(lr_init)) * (1.0 - t)
                         + torch.log(f32(lr_final)) * t)
    lr = delay_rate * log_lerp
    return torch.where(step < 0, torch.zeros_like(lr), lr)
