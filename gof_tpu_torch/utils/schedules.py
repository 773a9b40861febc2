"""Learning-rate schedules (counterpart of gof_tpu/utils/schedules.py): the
exponential log-lerp schedule with optional delayed warm start of
get_expon_lr_func (utils/general_utils.py:29-62)."""

from __future__ import annotations

import math

import torch


def expon_lr(step, lr_init: float, lr_final: float, max_steps: int, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0) -> torch.Tensor:
    """Log-linear interpolation from lr_init to lr_final over max_steps, as a
    0-d f32 tensor on `step`'s device (CPU for a Python number); 0 when the
    schedule is disabled or the step is negative, as in the reference."""
    step = torch.as_tensor(step, dtype=torch.float32)
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    # log(0) = -inf as in jnp.log; the final where hides it when lr_init == 0
    log_init = math.log(lr_init) if lr_init > 0 else -math.inf
    log_final = math.log(lr_final) if lr_final > 0 else -math.inf
    log_lerp = torch.exp(log_init * (1 - t) + log_final * t)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0))
    else:
        delay_rate = 1.0
    out = delay_rate * log_lerp
    ok = (step >= 0) & torch.tensor(lr_init != 0.0, device=step.device)
    return torch.where(ok, out, torch.zeros_like(out))
