"""Learning-rate schedules (counterpart of train/schedules.py).

The reference assigns its cyclic-triangular LR to a no-op attribute of torch
Adam, so the effective LR of the supervised trainer is the constant 1e-4
(SURVEY.md Q1); the constant is the default, the cyclic schedule an opt-in
(``--lr_schedule cyclic``).
"""
from __future__ import annotations

import torch


def cyclic_triangular(base_lr: float, max_lr: float, step_size: float,
                      gamma: float = 0.98):
    """clr(step) matching train:179-182 / nmmlp:377-379, evaluated on a
    per-fold step count [F] (the optimizer's count before the step; the
    reference's global_step starts at 1, hence count + 1).

    ``step_size = 2 * ceil(n_samples / batch_size)``.
    """

    def schedule(count: torch.Tensor) -> torch.Tensor:
        gs = count.to(torch.float32) + 1.0
        cycle = torch.floor(1.0 + gs / (2.0 * step_size))
        x = torch.abs(gs / step_size - 2.0 * cycle + 1.0)
        return base_lr + (max_lr - base_lr) * torch.clamp(1.0 - x, min=0.0) * (
            gamma ** cycle)

    return schedule
