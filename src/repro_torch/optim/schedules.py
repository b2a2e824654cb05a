"""Learning-rate schedules as pure ``step -> lr`` functions (counterpart
of ``repro/optim/schedules.py``): float32 0-d tensors on the step's
device, the reference's ``jnp`` arithmetic in the same order."""
from __future__ import annotations

import math

import torch


def _as_f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def constant(lr: float):
    return lambda step: torch.tensor(
        lr, dtype=torch.float32,
        device=step.device if isinstance(step, torch.Tensor) else None)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def f(step):
        step = _as_f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return f


def inverse_sqrt(peak_lr: float, warmup_steps: int):
    def f(step):
        step = _as_f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        decay = peak_lr * torch.sqrt(
            warmup_steps / torch.clamp(step, min=1.0))
        return torch.where(step < warmup_steps, warm, decay)
    return f


def make(name: str, lr: float, total_steps: int = 10000,
         warmup_steps: int = 100):
    """The schedule ``name`` ('constant', 'warmup_cosine' or
    'inverse_sqrt') peaking at ``lr``."""
    if name == "constant":
        return constant(lr)
    if name == "warmup_cosine":
        return warmup_cosine(lr, warmup_steps, total_steps)
    if name == "inverse_sqrt":
        return inverse_sqrt(lr, warmup_steps)
    raise ValueError(f"unknown schedule {name!r}")
