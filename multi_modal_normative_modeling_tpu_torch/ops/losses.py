"""Loss terms of the model zoo (counterpart of ops/losses.py).

Every term is fold-stacked: inputs carry a leading fold axis F and the
result is one value per fold, [F]. With a row ``mask`` [F, B] a term is the
masked mean over the valid rows of each fold, dividing by max(sum(mask), 1)
per fold, so a padded batch reproduces the reference's ``.mean(0)`` over the
real rows (cVAE.py:14-15, :1138-1139; SURVEY.md Q7).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

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


def neg_half_sse(x: torch.Tensor, recon: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """-0.5 * sum((x - recon)^2, features), mean over rows: the DMVAE
    family's 'll' (cVAE.py:1566). x, recon [F, B, D] -> [F]."""
    return _masked_mean(-0.5 * torch.sum((x - recon) ** 2, dim=-1), mask)


def _masked_element_mean(values: torch.Tensor,
                         mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over the rows and the last axis of values [F, B, W], over
    mask's rows: the sum over valid rows divided by max(rows * W, 1)."""
    if mask is None:
        return torch.mean(values, dim=(-2, -1))
    mask = mask.to(values.dtype)
    return (torch.sum(values * mask.unsqueeze(-1), dim=(-2, -1))
            / torch.clamp(torch.sum(mask, dim=-1) * values.shape[-1],
                          min=1.0))


def neg_mse(x: torch.Tensor, recon_mean: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """-MSE over all elements of a fold: nm-MLP's calc_ll (nmmlp.py:124-127).
    x, recon_mean [F, B, D] -> [F]."""
    return -_masked_element_mean((x - recon_mean) ** 2, mask)


def gaussian_kl_pair(mu_p: torch.Tensor, logvar_p: torch.Tensor,
                     mu_q: torch.Tensor, logvar_q: torch.Tensor
                     ) -> torch.Tensor:
    """Elementwise KL(N_p || N_q) of diagonal Gaussians (torch
    kl_divergence(Normal, Normal))."""
    var_p = torch.exp(logvar_p)
    var_q = torch.exp(logvar_q)
    return (0.5 * (logvar_q - logvar_p)
            + (var_p + (mu_p - mu_q) ** 2) / (2.0 * var_q) - 0.5)


def pairwise_jsd(mus: Sequence[torch.Tensor], logvars: Sequence[torch.Tensor],
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mmJSD's pairwise-KL regularizer (cVAE.py:1404-1411): the mean KL over
    the pairs i < j, each averaged over its elements. mus, logvars: one
    [F, B, Z] tensor per expert -> [F]; zero when there is no pair."""
    n = len(mus)
    total = mus[0].new_zeros(mus[0].shape[0])
    if n < 2:
        return total
    for i in range(n):
        for j in range(i + 1, n):
            total = total + _masked_element_mean(
                gaussian_kl_pair(mus[i], logvars[i], mus[j], logvars[j]),
                mask)
    return total / (n * (n - 1) / 2)


def margin_contrastive(deviation_health: torch.Tensor,
                       deviation_disease: torch.Tensor, labels: torch.Tensor,
                       margin: Union[float, torch.Tensor],
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The end-to-end model's margin contrastive loss over per-row
    deviations (cVAE.py:2176-2179): a label-0 row should sit closer to the
    health decoder, a label-1 row to the disease decoder. deviations and
    labels [F, B] -> [F]. ``margin`` is one float, or one per fold [F] (a
    sweep's stacked configs); equal values give equal results."""
    if isinstance(margin, torch.Tensor):
        margin = margin.to(deviation_health.dtype).reshape(-1, 1)
    labels = labels.to(deviation_health.dtype)
    zero = deviation_health.new_zeros(())
    per_row = ((1.0 - labels) * torch.maximum(
        margin + deviation_health - deviation_disease, zero)
        + labels * torch.maximum(
            margin + deviation_disease - deviation_health, zero))
    return _masked_mean(per_row, mask)


def cross_entropy_logits(logits: torch.Tensor, labels: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy of integer labels (torch F.cross_entropy):
    logits [F, B, K], labels [F, B] -> [F]."""
    log_z = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1,
                          labels.to(torch.int64).unsqueeze(-1)).squeeze(-1)
    return _masked_mean(log_z - picked, mask)
