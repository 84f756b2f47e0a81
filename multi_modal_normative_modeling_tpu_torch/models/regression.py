"""The continuous-score regression variant, cVAE_multimodal_regression
(counterpart of models/regression.py).

The cVAE_multimodal skeleton plus a regression head: an MLP (sum(D_m) ->
128 -> 64 -> 1, ReLU) fed the concatenated reconstruction residuals
x - x_hat of every modality (cVAE.py:2320-2323). Loss = the skeleton's
total + lambda * MSE(fi_pred, fi_true) (cVAE.py:2332-2346). The covariates
are the raw two columns [AGE, PTGENDER] (c_dim 2, regression script
:83-84).

The module is the port's ``MultimodalCVAE(variant="cvae")`` with the
regressor beside the encoders and decoders, so its state dict names the JAX
tree ``{"enc", "dec", "alpha", "regressor"}``. Scoring has a kernel path
and a plain one: ``pred_fi`` runs the encoder kernel per modality, fusion
in torch, the decoder-mean kernel per modality and the head in torch;
``roiwise_deviation`` one modality's encoder and decoder-mean kernels. On
CPU tensors the kernels' wrappers run their plain versions;
``pred_fi_reference`` and ``roiwise_deviation_reference`` are the plain
torch paths on any device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..ops.linear import apply_mlp, init_mlp
from ..ops.losses import _masked_mean
from .cvae import reparameterize
from .multimodal import MultimodalCVAE


class RegressionCVAE(MultimodalCVAE):
    def __init__(self, input_dim_list: Sequence[int],
                 hidden_dim: Sequence[int], latent_dim: int, c_dim: int,
                 modalities: int, non_linear: bool = True, folds: int = 1,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(input_dim_list, hidden_dim, latent_dim, c_dim,
                         modalities, non_linear, variant="cvae", folds=folds,
                         generator=generator, device=device)
        self.log_keys = ("total", "kl", "ll", "regression")
        self.regressor = init_mlp([sum(self.input_dim_list), 128, 64, 1],
                                  folds, generator, device)

    def regress(self, xes, recon_means) -> torch.Tensor:
        """The head on the residuals x - x_hat of every modality: [F, B, 1]."""
        residuals = torch.cat([x - mean for x, mean in zip(xes, recon_means)],
                              dim=-1)
        return apply_mlp([layer.pair() for layer in self.regressor],
                         residuals, activation=torch.relu)

    def forward(self, xes, cs, combine: str,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> dict:
        fwd = super().forward(xes, cs, combine, eps, generator)
        fwd["fi_pred"] = self.regress(xes, fwd["recon_means"])
        return fwd

    def loss(self, xes, fwd: dict, true_fi: torch.Tensor,
             lambda_reg: float = 1.0,
             mask: Optional[torch.Tensor] = None) -> dict:
        """The skeleton's terms plus ``regression``, the masked MSE of the
        prediction against ``true_fi`` [F, B]; ``total`` adds lambda times
        it. Each [F]."""
        losses = super().loss(xes, fwd, mask)
        err = (fwd["fi_pred"][..., 0] - true_fi) ** 2
        losses["regression"] = regression = _masked_mean(err, mask)
        losses["total"] = losses["total"] + lambda_reg * regression
        return losses

    # -- scoring ------------------------------------------------------------
    @torch.no_grad()
    def pred_fi(self, xes, cs, combine: str,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The FI prediction [F, B, 1] through the kernels: the encoder
        kernel per modality, fusion in torch, the decoder-mean kernel per
        modality, then the head in torch."""
        means = self.pred_recon_means_fused(xes, cs, combine, eps, generator)
        return self.regress(xes, means)

    @torch.no_grad()
    def pred_fi_reference(self, xes, cs, combine: str,
                          eps: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
        return self.forward(xes, cs, combine, eps, generator)["fi_pred"]

    @torch.no_grad()
    def roiwise_deviation(self, x: torch.Tensor, c: torch.Tensor,
                          modal_idx: int, eps: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
        """One modality's (x - x_hat)^2 [F, B, D] (regression script
        :183-188): its encoder kernel, z = mu + eps * sigma, its
        decoder-mean kernel."""
        mu, logvar = self.enc[modal_idx].fused(x, c)
        z = reparameterize(mu, logvar, eps, generator)
        return (x - self.dec[modal_idx].fused_mean(z, c)) ** 2

    @torch.no_grad()
    def roiwise_deviation_reference(self, x: torch.Tensor, c: torch.Tensor,
                                    modal_idx: int,
                                    eps: Optional[torch.Tensor] = None,
                                    generator: Optional[torch.Generator] = None
                                    ) -> torch.Tensor:
        mu, logvar = self.enc[modal_idx](x, c)
        z = reparameterize(mu, logvar, eps, generator)
        return (x - self.dec[modal_idx](z, c)[0]) ** 2


def regression_loss_fn(model: RegressionCVAE, combine: str,
                       lambda_reg: float = 1.0):
    """The regression CLI's training loss (cli/regression.py:126-132 of the
    JAX package): forward on the step's eps, then the loss against the
    batch's FI extra."""

    def loss_fn(batch: dict, eps: torch.Tensor):
        fwd = model(batch["x"], batch["c"], combine, eps=eps)
        losses = model.loss(batch["x"], fwd, batch["extras"]["fi"][..., 0],
                            lambda_reg=lambda_reg, mask=batch["mask"])
        return losses["total"], losses

    return loss_fn
