"""The end-to-end supervised dual-decoder model, nm-PM-cont (counterpart of
models/endtoend.py).

Shared per-modality encoders, a *health* and a *disease* decoder bank, PoE
latent fusion over (mu, logvar) (cVAE.py:2083-2090) and a latent classifier
head (models/cvae.Classifier). The loss (cVAE.py:2140-2200):

  weight_rec * (recon_nll_health + recon_nll_disease)
  + weight_kl * KL(fused || N(0, I))
  + cross_entropy(classifier logits, labels)
  + weight_contrastive * margin contrastive over the mean-over-modalities
    deviations (a label-0 row should sit closer to the health decoder, a
    label-1 row to the disease decoder).

``predict`` classifies from the fused mean without sampling (cVAE.py:2202),
in eval mode (BatchNorm running statistics, no dropout).

As every model of the port, the module holds every fold of a k-fold model:
each parameter and BatchNorm buffer has a leading fold axis F and inputs are
[F, B, ...]. The reparameterization noise of a step is ``eps`` [F, B, Z]
and the dropout keep masks one [F, B, width] per classifier block, given or
drawn from a generator.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from ..ops.fusion import poe_logvar
from ..ops.losses import (
    cross_entropy_logits,
    gaussian_ll,
    kl_standard_normal,
    margin_contrastive,
)
from .cvae import Classifier, Decoder, Encoder, reparameterize

# a loss hyperparameter: one float, or one value per fold [F]
Hyper = Union[float, torch.Tensor]

LOG_KEYS = ("total_loss", "recon_loss_health", "recon_loss_disease",
            "kl_loss", "classification_loss", "contrastive_loss")


class EndToEndCVAE(nn.Module):
    def __init__(self, input_dim_list: Sequence[int],
                 hidden_dim: Sequence[int], latent_dim: int, c_dim: int,
                 modalities: int, non_linear: bool = True,
                 classifier_layers: Sequence[int] = (128, 64),
                 dropout_rate: float = 0.5, num_classes: int = 2,
                 folds: int = 1, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.input_dim_list = list(input_dim_list)
        self.hidden_dim = list(hidden_dim)
        self.latent_dim = latent_dim
        self.c_dim = c_dim
        self.modalities = modalities
        self.non_linear = non_linear
        self.classifier_layers = list(classifier_layers)
        self.dropout_rate = dropout_rate
        self.num_classes = num_classes
        self.folds = folds
        self.noise_dim = latent_dim
        self.log_keys = LOG_KEYS

        def bank(cls):
            return nn.ModuleList(
                cls(self.input_dim_list[i], hidden_dim, latent_dim, c_dim,
                    non_linear, folds, generator=generator, device=device)
                for i in range(modalities))

        self.enc = bank(Encoder)
        self.dec_health = bank(Decoder)
        self.dec_disease = bank(Decoder)
        self.classifier = Classifier(latent_dim, classifier_layers,
                                     num_classes, dropout_rate, folds,
                                     generator, device)

    @property
    def keep_widths(self) -> tuple:
        """The widths of the dropout keep masks a training step draws, one
        per classifier block (none without dropout)."""
        return self.classifier.widths if self.dropout_rate > 0.0 else ()

    def _fuse(self, stats):
        return poe_logvar(torch.stack([mu for mu, _ in stats]),
                          torch.stack([lv for _, lv in stats]))

    def encode_fuse(self, xes, cs):
        """PoE over every modality's (mu, logvar): (fused_mu, fused_logvar),
        each [F, B, Z]."""
        return self._fuse([enc(xes[i], cs[i])
                           for i, enc in enumerate(self.enc)])

    def forward(self, xes, cs, eps: Optional[torch.Tensor] = None,
                train: bool = True, mask: Optional[torch.Tensor] = None,
                keep: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> dict:
        fused_mu, fused_logvar = self.encode_fuse(xes, cs)
        z = reparameterize(fused_mu, fused_logvar, eps, generator)
        logits, bn_state = self.classifier(z, train, mask, keep, generator)
        return {
            "recons_health": [dec(z, cs[i])
                              for i, dec in enumerate(self.dec_health)],
            "recons_disease": [dec(z, cs[i])
                               for i, dec in enumerate(self.dec_disease)],
            "mu": fused_mu,
            "logvar": fused_logvar,
            "logits": logits,
            "bn_state": bn_state,
        }

    def loss(self, xes, fwd: dict, labels: torch.Tensor,
             margin: Hyper = 1.0, weight_contrastive: Hyper = 0.1,
             weight_kl: float = 0.1, weight_rec: float = 0.1,
             mask: Optional[torch.Tensor] = None) -> dict:
        """The loss terms per fold, each [F] (``log_keys``); ``labels``
        [F, B] are 0 for a control, 1 for a patient. ``margin`` and
        ``weight_contrastive`` are floats, or one value per fold [F] (a
        sweep's configs stacked on the fold axis)."""
        recon_h = 0.0
        recon_d = 0.0
        dev_h, dev_d = [], []
        for i in range(self.modalities):
            mean_h, lv_h = fwd["recons_health"][i]
            mean_d, lv_d = fwd["recons_disease"][i]
            recon_h += -gaussian_ll(xes[i], mean_h, lv_h, mask)
            recon_d += -gaussian_ll(xes[i], mean_d, lv_d, mask)
            dev_h.append(torch.mean((xes[i] - mean_h) ** 2, dim=-1))
            dev_d.append(torch.mean((xes[i] - mean_d) ** 2, dim=-1))
        deviation_h = torch.stack(dev_h).mean(dim=0)
        deviation_d = torch.stack(dev_d).mean(dim=0)
        contrastive = margin_contrastive(deviation_h, deviation_d, labels,
                                         margin, mask)
        kl = kl_standard_normal(fwd["mu"], fwd["logvar"], mask)
        ce = cross_entropy_logits(fwd["logits"], labels, mask)
        total = (weight_rec * (recon_h + recon_d) + weight_kl * kl + ce
                 + weight_contrastive * contrastive)
        return {
            "total_loss": total,
            "recon_loss_health": recon_h,
            "recon_loss_disease": recon_d,
            "kl_loss": kl,
            "classification_loss": ce,
            "contrastive_loss": contrastive,
        }

    def update_state(self, aux: dict, valid: torch.Tensor) -> None:
        """The trainer's state update: the BatchNorm running statistics of
        a step (``aux["bn_state"]``) into the buffers of its valid folds."""
        self.classifier.update_state(aux["bn_state"], valid)

    @torch.no_grad()
    def predict(self, xes, cs) -> torch.Tensor:
        """Eval-mode classifier logits [F, B, classes] from the fused mean
        (cVAE.py:2202): each modality's encoder through the encoder kernel
        (one launch for every fold; its plain version on CPU tensors), PoE
        and the head in torch."""
        fused_mu, _ = self._fuse([enc.fused(xes[i], cs[i])
                                  for i, enc in enumerate(self.enc)])
        return self.classifier(fused_mu, train=False)[0]

    @torch.no_grad()
    def predict_reference(self, xes, cs) -> torch.Tensor:
        """``predict`` through the plain torch encoders."""
        fused_mu, _ = self.encode_fuse(xes, cs)
        return self.classifier(fused_mu, train=False)[0]


def endtoend_loss_fn(model: EndToEndCVAE, margin: Hyper,
                     weight_contrastive: Hyper):
    """The nm-PM-cont CLI's training loss (cli/nmpmcont.py:154-165 of the
    JAX package): forward in train mode on the step's eps and keep masks,
    then the loss with the default KL and reconstruction weights. The aux
    carries the step's BatchNorm statistics for ``model.update_state``."""

    def loss_fn(batch: dict, eps: torch.Tensor):
        labels = batch["extras"]["labels"][..., 0]
        fwd = model(batch["x"], batch["c"], eps, train=True,
                    mask=batch["mask"], keep=batch.get("keep"))
        losses = model.loss(batch["x"], fwd, labels, margin=margin,
                            weight_contrastive=weight_contrastive,
                            mask=batch["mask"])
        losses["bn_state"] = fwd["bn_state"]
        return losses["total_loss"], losses

    return loss_fn
