"""The shared-skeleton multimodal cVAE family (counterpart of
models/multimodal.py): cVAE_multimodal, mmJSD, mvtCAE and the nm-MLP model.

All share M conditional encoders, a fusion of their latent statistics,
z = mu + eps * sigma, M conditional decoders and the learnable gPoE weights;
they differ in the fusion and in the loss:

  cvae    fusion by ``combine`` (poe, gpoe, moe or mopoe) with the
          single-modality shortcut (cVAE.py:1146); loss_m = KL - gaussian_ll
          (cVAE.py:1087-1214).
  mmjsd   fusion always precision-weighted over exp(logvars), whatever
          ``combine`` says (cVAE.py:1399); every modality's term adds the
          pairwise-KL "JSD" regularizer (cVAE.py:1425-1435). The reference
          computes it over M copies of the fused statistics (cVAE.py:1427),
          which is identically zero; ``jsd_on_fused=True`` reproduces that,
          False gives the per-modality JSD.
  mvtcae  no shortcut; fused variance clamped >= 1e-6 (cVAE.py:1824); loss_m
          = KL + 1e-5 * ll + beta (1e-4) * TC with the degenerate TC term of
          ``total_correlation``; its 'poe' branch goes through
          ``poe_logvar`` with variances where logvars are expected
          (cVAE.py:1782-1783), reproduced as it is.
  nmmlp   the cvae loss with -MSE as the log-likelihood (nmmlp:124-127) and
          no shortcut (nmmlp:129-143).

The module holds every fold of a k-fold model: each parameter has a leading
fold axis F, inputs are [F, B, ...] per modality, the stacked expert
statistics are [M, F, B, Z], and ``alpha`` (the gPoE weights) is [F, M].
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from ..kernels.deviation import reconstruction_deviation
from ..ops import fusion
from ..ops.losses import (
    gaussian_ll,
    kl_standard_normal,
    neg_mse,
    pairwise_jsd,
)
from .cvae import Decoder, Encoder, reparameterize

VARIANTS = ("cvae", "mmjsd", "mvtcae", "nmmlp")
MVTCAE_BETA = 0.0001  # cVAE.py:1771


def total_correlation(mus_stack: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mvtCAE's TC term as cVAE.py:1859-1865 computes it: the reference's
    ``log_qz_xi`` is a scalar minus its own mean, zero, so the term reduces
    to -sum_z mean_m logsumexp_rows(mus[m, :, z]). mus_stack [M, F, B, Z],
    mask [F, B] -> [F]. A fold whose rows are all masked gives +inf (and a
    NaN gradient): the trainers drop such a fold's step."""
    if mask is not None:
        mus_stack = torch.where(mask[None, :, :, None] > 0, mus_stack,
                                mus_stack.new_tensor(float("-inf")))
    lse = torch.logsumexp(mus_stack, dim=2)  # [M, F, Z]
    return -torch.sum(torch.mean(lse, dim=0), dim=-1)


class MultimodalCVAE(nn.Module):
    def __init__(self, input_dim_list: Sequence[int],
                 hidden_dim: Sequence[int], latent_dim: int, c_dim: int,
                 modalities: int, non_linear: bool = True,
                 variant: str = "cvae", folds: int = 1,
                 generator: Optional[torch.Generator] = None, device=None,
                 jsd_on_fused: bool = True):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"MultimodalCVAE variant {variant!r} is not "
                             f"one of {VARIANTS}")
        self.input_dim_list = list(input_dim_list)
        self.hidden_dim = list(hidden_dim)
        self.latent_dim = latent_dim
        self.c_dim = c_dim
        self.modalities = modalities
        self.non_linear = non_linear
        self.variant = variant
        self.jsd_on_fused = jsd_on_fused
        self.mvtcae_beta = MVTCAE_BETA
        self.folds = folds
        # the width of the reparameterization noise, and the loss terms the
        # trainers log, in the order they log them
        self.noise_dim = latent_dim
        self.log_keys = ("total", "kl", "ll") + {
            "mmjsd": ("jsd",), "mvtcae": ("tc",)}.get(variant, ())
        self.enc = nn.ModuleList(
            Encoder(self.input_dim_list[i], hidden_dim, latent_dim, c_dim,
                    non_linear, folds, generator, device)
            for i in range(modalities))
        self.dec = nn.ModuleList(
            Decoder(self.input_dim_list[i], hidden_dim, latent_dim, c_dim,
                    non_linear, folds, generator=generator, device=device)
            for i in range(modalities))
        gen_device = generator.device if generator is not None else "cpu"
        alpha = torch.randn((folds, modalities), generator=generator,
                            device=gen_device)
        self.alpha = nn.Parameter(alpha.to(device))

    # -- forward ------------------------------------------------------------
    def encode_all(self, xes: Sequence[torch.Tensor],
                   cs: Sequence[torch.Tensor]):
        """Stacked expert statistics (mus, logvars), each [M, F, B, Z]."""
        stats = [enc(xes[i], cs[i]) for i, enc in enumerate(self.enc)]
        return (torch.stack([mu for mu, _ in stats]),
                torch.stack([lv for _, lv in stats]))

    def fuse(self, mus: torch.Tensor, logvars: torch.Tensor, combine: str):
        """Returns (fused_mu, fused_logvar), each [F, B, Z]."""
        variances = torch.exp(logvars)
        if self.variant == "mmjsd":
            # always precision-weighted, no shortcut (cVAE.py:1399-1402)
            fused_mu, fused_var = fusion.product_of_experts(mus, variances)
        elif self.variant == "mvtcae":
            if combine.lower() == "poe":
                # reference quirk: ProductOfExperts2 fed variances as logvars
                fused_mu, fused_var = fusion.poe_logvar(mus, variances)
            else:
                fused_mu, fused_var = fusion.combine_latent(
                    mus, variances, combine, self.alpha,
                    single_modality_shortcut=False)
            fused_var = torch.clamp(fused_var, min=1e-6)  # cVAE.py:1824
        else:
            fused_mu, fused_var = fusion.combine_latent(
                mus, variances, combine, self.alpha,
                single_modality_shortcut=(self.variant != "nmmlp"))
        return fused_mu, torch.log(fused_var)

    def forward(self, xes: Sequence[torch.Tensor],
                cs: Sequence[torch.Tensor], combine: str,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> dict:
        """forward_multimodal: encode -> fuse -> reparameterize -> decode."""
        mus, logvars = self.encode_all(xes, cs)
        fused_mu, fused_logvar = self.fuse(mus, logvars, combine)
        z = reparameterize(fused_mu, fused_logvar, eps, generator)
        decoded = [dec(z, cs[i]) for i, dec in enumerate(self.dec)]
        return {
            "recon_means": [mean for mean, _ in decoded],
            "recon_logvars": [lv for _, lv in decoded],
            "mu_multimodal": fused_mu,
            "logvar_multimodal": fused_logvar,
            "mus": mus,
            "logvars": logvars,
            "z": z,
        }

    # -- losses ---------------------------------------------------------------
    def loss(self, xes: Sequence[torch.Tensor], fwd: dict,
             mask: Optional[torch.Tensor] = None) -> dict:
        """The variant's loss terms per fold, each [F] (``log_keys``):
        kl = M * KL, ll = sum of ll_m, and total = sum over modalities of
        KL - ll_m (cvae, cVAE.py:1187-1196; nmmlp), KL + jsd - ll_m (mmjsd)
        or KL + 1e-5 * ll_m + beta * tc (mvtcae; ``tc`` is logged times M).
        ``mask`` [F, B] marks the valid rows."""
        kl = kl_standard_normal(fwd["mu_multimodal"],
                                fwd["logvar_multimodal"], mask)
        extras = {}
        if self.variant == "mmjsd":
            if self.jsd_on_fused:
                # cVAE.py:1427: the JSD over M copies of the fused statistics
                stats = [fwd["mu_multimodal"]] * self.modalities
                lvs = [fwd["logvar_multimodal"]] * self.modalities
            else:
                stats, lvs = list(fwd["mus"]), list(fwd["logvars"])
            extras["jsd"] = jsd = pairwise_jsd(stats, lvs, mask)
        elif self.variant == "mvtcae":
            tc = total_correlation(fwd["mus"], mask)
            extras["tc"] = tc * self.modalities
        kl_total = 0.0
        ll_total = 0.0
        total = 0.0
        for i in range(self.modalities):
            if self.variant == "nmmlp":
                ll = neg_mse(xes[i], fwd["recon_means"][i], mask)
            else:
                ll = gaussian_ll(xes[i], fwd["recon_means"][i],
                                 fwd["recon_logvars"][i], mask)
            kl_total += kl
            ll_total += ll
            if self.variant == "mmjsd":
                total += kl + jsd - ll
            elif self.variant == "mvtcae":
                total += kl + 0.00001 * ll + self.mvtcae_beta * tc
            else:
                total += kl - ll
        return {"total": total, "kl": kl_total, "ll": ll_total, **extras}

    # -- inference ------------------------------------------------------------
    def pred_recon(self, xes, cs, combine: str,
                   eps: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> List[torch.Tensor]:
        """Stochastic reconstruction at test time (cVAE.py:1198-1208 —
        reparameterize is used even for inference, SURVEY.md Q2)."""
        return self.forward(xes, cs, combine, eps, generator)["recon_means"]

    reconstruction_deviation = staticmethod(reconstruction_deviation)

    def latent_stats(self, xes, cs, combine: str):
        """(fused_mu, fused_var) without sampling (utils_vae.py:155-161)."""
        mus, logvars = self.encode_all(xes, cs)
        fused_mu, fused_logvar = self.fuse(mus, logvars, combine)
        return fused_mu, torch.exp(fused_logvar)

    def _fused_posterior(self, xes, cs, combine: str):
        """(fused_mu, fused_logvar), [F, B, Z]: the encoder kernel per
        modality, each launch covering every fold, then the fusion in
        torch."""
        stats = [enc.fused(xes[i], cs[i]) for i, enc in enumerate(self.enc)]
        return self.fuse(torch.stack([mu for mu, _ in stats]),
                         torch.stack([lv for _, lv in stats]), combine)

    @torch.no_grad()
    def latent_stats_fused(self, xes, cs, combine: str):
        """``latent_stats`` through the encoder kernel: (fused_mu,
        fused_var), [F, B, Z], no sampling; numerically equivalent to
        latent_stats. Inference only."""
        fused_mu, fused_logvar = self._fused_posterior(xes, cs, combine)
        return fused_mu, torch.exp(fused_logvar)

    @torch.no_grad()
    def pred_recon_fused(self, xes, cs, combine: str,
                         eps: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None):
        """The test stage's scoring entry: the encoder kernel per modality,
        fusion in torch, then one decode+deviation kernel per modality, each
        launch covering every fold. Returns (recon_means, deviations) lists,
        [F, B, D_m] and [F, B]; numerically equivalent to pred_recon plus
        reconstruction_deviation on the same eps. Inference only."""
        fused_mu, fused_logvar = self._fused_posterior(xes, cs, combine)
        z = reparameterize(fused_mu, fused_logvar, eps, generator)
        out = [dec.fused_pred_deviation(z, cs[i], xes[i])
               for i, dec in enumerate(self.dec)]
        return [recon for recon, _ in out], [dev for _, dev in out]

    @torch.no_grad()
    def pred_recon_means_fused(self, xes, cs, combine: str,
                               eps: Optional[torch.Tensor] = None,
                               generator: Optional[torch.Generator] = None
                               ) -> List[torch.Tensor]:
        """``pred_recon`` through the kernels: the encoder kernel per
        modality, fusion in torch, then the decoder-mean kernel per
        modality (no x, no deviation). Returns the recon means [F, B, D_m];
        numerically equivalent to pred_recon on the same eps."""
        fused_mu, fused_logvar = self._fused_posterior(xes, cs, combine)
        z = reparameterize(fused_mu, fused_logvar, eps, generator)
        return [dec.fused_mean(z, cs[i]) for i, dec in enumerate(self.dec)]
