"""Loss terms of the cVAE (counterpart of ops/losses.py, main-path terms).

Every term is fold-stacked: inputs carry a leading fold axis F and the
result is one value per fold, [F]. With a row ``mask`` [F, B] a term is the
masked mean over the valid rows of each fold, dividing by max(sum(mask), 1)
per fold, so a padded batch reproduces the reference's ``.mean(0)`` over the
real rows (cVAE.py:14-15, :1138-1139; SURVEY.md Q7).
"""
from __future__ import annotations

from typing import Optional

import torch

HALF_LOG_2PI = 0.9189385332046727  # 0.5 * log(2*pi)


def _masked_mean(per_row: torch.Tensor,
                 mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over the last (row) axis of per_row [F, B], over mask's rows."""
    if mask is None:
        return torch.mean(per_row, dim=-1)
    mask = mask.to(per_row.dtype)
    return (torch.sum(per_row * mask, dim=-1)
            / torch.clamp(torch.sum(mask, dim=-1), min=1.0))


def kl_standard_normal(mu: torch.Tensor, logvar: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KL(N(mu, exp(logvar)) || N(0, I)), summed over latent dims, mean over
    rows: mu, logvar [F, B, Z] -> [F]."""
    per_row = -0.5 * torch.sum(1.0 + logvar - mu ** 2 - torch.exp(logvar),
                               dim=-1)
    return _masked_mean(per_row, mask)


def gaussian_ll_rows(x: torch.Tensor, mean: torch.Tensor,
                     logvar_out: torch.Tensor) -> torch.Tensor:
    """Per-row Gaussian log-likelihood of x under N(mean, exp(logvar_out)),
    summed over features: x, mean [F, B, D], logvar_out [F, 1, D] ->
    [F, B]."""
    inv_var = torch.exp(-logvar_out)
    return torch.sum(
        -0.5 * (x - mean) ** 2 * inv_var - 0.5 * logvar_out - HALF_LOG_2PI,
        dim=-1)


def gaussian_ll(x: torch.Tensor, mean: torch.Tensor, logvar_out: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch ``Normal.log_prob(x).sum(1).mean(0)`` with the decoder's
    learnable homoscedastic output logvar (cVAE.py:14-15, :193-206), per
    fold: [F]."""
    return _masked_mean(gaussian_ll_rows(x, mean, logvar_out), mask)
