"""The FI regression on the width-grouped packed layout (counterpart of
models/grouped_regression.py).

RegressionCVAE (models/regression.py) is the cvae skeleton plus a
regression MLP on the concatenated residuals x - x_hat of every modality.
The skeleton packs as models/grouped.GroupedStackedCVAE (variant cvae);
the residuals are put back in the cohort's modality order (the head's
input feature order is part of the numerics), and the head stays the
model's own module (``regress``), one narrow MLP.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..ops.losses import _masked_mean
from .grouped import GroupedStackedCVAE


class GroupedRegressionCVAE(GroupedStackedCVAE):
    """The packed form of RegressionCVAE's skeleton; ``forward`` takes the
    model's head as ``regress(xes, recon_means)``."""

    def __init__(self, input_dim_list: Sequence[int],
                 hidden_dim: Sequence[int], latent_dim: int, c_dim: int,
                 modalities: int, non_linear: bool = True):
        super().__init__(input_dim_list, hidden_dim, latent_dim, c_dim,
                         modalities, non_linear, variant="cvae")

    def per_modality(self, groups) -> list:
        """Per-group [F, G, B, d] tensors -> per-modality [F, B, d] in the
        cohort's order."""
        return [groups[gi][:, row] for gi, row in self.locate]

    def forward(self, params, x_groups, c: torch.Tensor, combine: str,
                eps: torch.Tensor, regress: Callable) -> dict:
        fwd = super().forward(params, x_groups, c, combine, eps)
        fwd["fi_pred"] = regress(self.per_modality(x_groups),
                                 self.per_modality(fwd["recon_means"]))
        return fwd

    def loss(self, params, x_groups, fwd: dict, true_fi: torch.Tensor,
             lambda_reg: float = 1.0,
             mask: Optional[torch.Tensor] = None) -> dict:
        """The skeleton's terms plus ``regression``, the masked MSE of the
        prediction against ``true_fi`` [F, B]."""
        losses = super().loss(params, x_groups, fwd, mask)
        err = (fwd["fi_pred"][..., 0] - true_fi) ** 2
        losses["regression"] = regression = _masked_mean(err, mask)
        losses["total"] = losses["total"] + lambda_reg * regression
        return losses

    def pred_fi(self, params, x_groups, c, combine: str, eps,
                regress: Callable) -> torch.Tensor:
        return self.forward(params, x_groups, c, combine, eps,
                            regress)["fi_pred"]
