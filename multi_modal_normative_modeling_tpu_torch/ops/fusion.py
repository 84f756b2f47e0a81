"""Latent expert-fusion ops (counterpart of ops/fusion.py).

Every op takes stacked per-modality statistics [M, ..., Z] (M experts first;
the port carries a fold axis behind it, [M, F, B, Z]) and reduces over axis
0. The parity notes of the JAX module hold here unchanged: ``product_of_experts``
is the net math of the reference's ProductOfExperts (returns a variance),
``gpoe`` softmaxes its per-modality weights over the modality axis, and
``mixture_of_experts`` is the arithmetic mean of means and variances.
"""
from __future__ import annotations

from typing import Optional

import torch

from .linear import fold_expand


def product_of_experts(mus: torch.Tensor, variances: torch.Tensor):
    """Precision-weighted product of Gaussian experts over axis 0."""
    precision = 1.0 / variances
    total_precision = torch.sum(precision, dim=0)
    fused_mu = torch.sum(mus * precision, dim=0) / total_precision
    fused_var = 1.0 / total_precision
    return fused_mu, fused_var


def gpoe(mus: torch.Tensor, variances: torch.Tensor, alpha: torch.Tensor):
    """Generalized PoE with learnable per-modality weights.

    ``alpha`` is [..., M]: [M] for one model, [F, M] for fold-stacked
    statistics [M, F, B, Z]. The softmax over modalities scales each
    expert's precision (cVAE.py:1154-1157)."""
    weights = torch.softmax(alpha, dim=-1).movedim(-1, 0)
    weights = weights.reshape(weights.shape
                              + (1,) * (mus.dim() - weights.dim()))
    weighted_precision = fold_expand(weights, variances.shape) / variances
    total = torch.sum(weighted_precision, dim=0)
    fused_mu = torch.sum(mus * weighted_precision, dim=0) / total
    fused_var = 1.0 / total
    return fused_mu, fused_var


def mixture_of_experts(mus: torch.Tensor, variances: torch.Tensor):
    """Uniform mixture: arithmetic mean of means and variances."""
    m = mus.shape[0]
    fused_mu = torch.sum(mus, dim=0) / m
    fused_var = torch.sum(variances, dim=0) / m
    return fused_mu, fused_var


def mixture_of_product_of_experts(mus: torch.Tensor,
                                  variances: torch.Tensor):
    """MoPoE: append the PoE expert, then take the uniform mixture."""
    poe_mu, poe_var = product_of_experts(mus, variances)
    mus_ext = torch.cat([mus, poe_mu[None]], dim=0)
    var_ext = torch.cat([variances, poe_var[None]], dim=0)
    return mixture_of_experts(mus_ext, var_ext)


def poe_logvar(mus: torch.Tensor, logvars: torch.Tensor):
    """PoE over (mu, logvar) returning a true logvar (ProductOfExperts2)."""
    precision = torch.exp(-logvars)
    total = torch.sum(precision, dim=0)
    fused_mu = torch.sum(mus * precision, dim=0) / total
    fused_logvar = -torch.log(total)
    return fused_mu, fused_logvar


def combine_latent(mus: torch.Tensor, variances: torch.Tensor, combine: str,
                   alpha: Optional[torch.Tensor] = None,
                   single_modality_shortcut: bool = True):
    """Dispatch on the fusion name, matching cVAE_multimodal.combine_latent
    (cVAE.py:1144-1164) including the M==1 shortcut at :1146."""
    if single_modality_shortcut and mus.shape[0] == 1:
        return mus[0], variances[0]
    combine = combine.lower()
    if combine == "poe":
        return product_of_experts(mus, variances)
    if combine == "gpoe":
        if alpha is None:
            raise ValueError("gpoe requires alpha weights")
        return gpoe(mus, variances, alpha)
    if combine == "moe":
        return mixture_of_experts(mus, variances)
    if combine == "mopoe":
        return mixture_of_product_of_experts(mus, variances)
    raise ValueError("No such combination method")
