"""Learning-rate schedules (paper protocol: cosine to 0.05x peak, 2k
warmup): the counterpart of ``repro/core/schedule.py``.  A schedule maps
the step count to a 0-dim fp32 tensor, computed in fp32 with the
reference's operation order."""
from __future__ import annotations

import math

import torch


def constant(value: float):
    return lambda step: torch.tensor(value, dtype=torch.float32)


def linear_warmup_cosine(peak_lr: float, total_steps: int,
                         warmup_steps: int = 2000,
                         final_lr_ratio: float = 0.05):
    """Cosine decay to ``final_lr_ratio * peak`` with linear warmup, pinned
    to ``total_steps`` (the paper's eq. 14 methodology)."""
    final_lr = peak_lr * final_lr_ratio

    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        frac = frac.clamp(0.0, 1.0)
        cos = final_lr + 0.5 * (peak_lr - final_lr) * (
            1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, cos).to(torch.float32)

    return schedule
