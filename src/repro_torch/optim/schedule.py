"""LR schedule: linear warmup + cosine decay — the port of
``repro/optim/schedule.py``, in float32 as the reference computes it.

A Python int step is divided in Python (float64) and then rounded to
float32, as JAX does with a Python scalar; a tensor step is cast to
float32 and divided as a float32 tensor (by a tensor, never by a Python
scalar, which PyTorch on CUDA turns into a multiply by the reciprocal).
Returns a 0-d float32 tensor on the step's device (the CPU for an int).
"""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1) -> torch.Tensor:
    f32 = torch.float32
    warm_div = max(warmup_steps, 1)
    decay_div = max(total_steps - warmup_steps, 1)
    if isinstance(step, torch.Tensor):
        step = step.to(f32)

        def const(x):
            return torch.tensor(float(x), dtype=f32, device=step.device)

        warm_frac = step / const(warm_div)
        t = (step - const(warmup_steps)) / const(decay_div)
        before = step < warmup_steps
    else:
        step = float(step)
        warm_frac = torch.tensor(step / warm_div, dtype=f32)
        t = torch.tensor((step - warmup_steps) / decay_div, dtype=f32)
        before = torch.tensor(step < warmup_steps)
    warm = peak_lr * torch.clamp(warm_frac, max=1.0)
    t = torch.clamp(t, 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(before, warm, peak_lr * cos)
