"""Learning-rate schedules (paper protocol: cosine to 0.05x peak, 2k
warmup): the counterpart of ``repro/core/schedule.py``.  A schedule maps
the step count to a 0-dim fp32 tensor, computed in fp32 with the
reference's operation order."""
from __future__ import annotations

import math

import torch


def constant(value: float):
    return lambda step: torch.tensor(value, dtype=torch.float32)


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup_cosine(peak_lr: float, total_steps: int,
                         warmup_steps: int = 2000,
                         final_lr_ratio: float = 0.05):
    """Cosine decay to ``final_lr_ratio * peak`` with linear warmup, pinned
    to ``total_steps`` (the paper's eq. 14 methodology)."""
    final_lr = peak_lr * final_lr_ratio

    def schedule(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        frac = frac.clamp(0.0, 1.0)
        cos = final_lr + 0.5 * (peak_lr - final_lr) * (
            1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, cos).to(torch.float32)

    return schedule


def linear_warmup_linear_decay(peak_lr: float, total_steps: int,
                               warmup_steps: int = 2000,
                               final_lr_ratio: float = 0.0):
    """Linear warmup, then a linear decay to ``final_lr_ratio * peak`` at
    ``total_steps``."""
    final_lr = peak_lr * final_lr_ratio

    def schedule(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        frac = frac.clamp(0.0, 1.0)
        dec = peak_lr + frac * (final_lr - peak_lr)
        return torch.where(step < warmup_steps, warm, dec).to(torch.float32)

    return schedule


def inverse_sqrt(peak_lr: float, warmup_steps: int = 2000):
    """Linear warmup, then ``peak * sqrt(warmup / step)``."""

    def schedule(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        decay = peak_lr * torch.sqrt(
            warmup_steps / torch.clamp_min(step, warmup_steps))
        return torch.where(step < warmup_steps, warm, decay).to(
            torch.float32)

    return schedule
