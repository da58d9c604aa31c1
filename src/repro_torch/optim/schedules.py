"""Learning-rate schedules (counterpart of ``repro.optim.schedules``).
These modulate gamma' (the step-size budget), NOT the delay adaptation --
the paper's gamma_k <= gamma' - window_sum principle composes with any
schedule on gamma' as long as the window sums use the *emitted* gammas
(which core.stepsize guarantees by construction).  Each schedule maps an
integer step tensor to a float32 0-d tensor on its device."""
from __future__ import annotations

import math

import torch

from ..core.stepsize import f32

__all__ = ["constant", "linear_warmup", "cosine_decay", "SCHEDULES"]


def constant(value: float):
    return lambda step: f32(value, torch.as_tensor(step))


def linear_warmup(base: float, warmup_steps: int):
    def fn(step):
        s = torch.as_tensor(step).to(torch.float32)
        frac = torch.clamp(s / f32(max(warmup_steps, 1), s), max=1.0)
        return f32(base, s) * frac
    return fn


def cosine_decay(base: float, total_steps: int, warmup_steps: int = 0,
                 final_frac: float = 0.1):
    def fn(step):
        s = torch.as_tensor(step).to(torch.float32)
        one = f32(1.0, s)
        warm = (torch.clamp(s / f32(max(warmup_steps, 1), s), max=1.0)
                if warmup_steps else one)
        prog = torch.clamp((s - f32(warmup_steps, s))
                           / f32(max(total_steps - warmup_steps, 1), s),
                           0.0, 1.0)
        cos = f32(final_frac, s) + f32((1 - final_frac) * 0.5, s) * (
            one + torch.cos(f32(math.pi, s) * prog))
        return f32(base, s) * warm * cos
    return fn


SCHEDULES = {"constant": constant, "linear_warmup": linear_warmup,
             "cosine": cosine_decay}
