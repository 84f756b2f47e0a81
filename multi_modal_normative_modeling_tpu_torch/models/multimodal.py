"""The multimodal cVAE (counterpart of models/multimodal.py, variant "cvae").

cVAE_multimodal (cVAE.py:1087-1214): M conditional encoders, fusion of their
latent statistics by ``combine`` (poe, gpoe, moe or mopoe, with the
single-modality shortcut of cVAE.py:1146), z = mu + eps * sigma, and M
conditional decoders.

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
from ..ops.losses import gaussian_ll, kl_standard_normal
from .cvae import Decoder, Encoder, reparameterize


class MultimodalCVAE(nn.Module):
    def __init__(self, input_dim_list: Sequence[int],
                 hidden_dim: Sequence[int], latent_dim: int, c_dim: int,
                 modalities: int, non_linear: bool = True,
                 variant: str = "cvae", folds: int = 1,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if variant != "cvae":
            raise NotImplementedError(
                f"MultimodalCVAE variant {variant!r} is not ported yet; "
                "see ROADMAP.md, queue 1 item 'Zoo'")
        self.input_dim_list = list(input_dim_list)
        self.hidden_dim = list(hidden_dim)
        self.latent_dim = latent_dim
        self.c_dim = c_dim
        self.modalities = modalities
        self.non_linear = non_linear
        self.variant = variant
        self.folds = folds
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
        fused_mu, fused_var = fusion.combine_latent(
            mus, torch.exp(logvars), combine, self.alpha)
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
        """The cvae ELBO terms per fold, each [F]: total = sum over
        modalities of (KL - ll_m), kl = M * KL, ll = sum of ll_m
        (cVAE.py:1187-1196). ``mask`` [F, B] marks the valid rows."""
        kl = kl_standard_normal(fwd["mu_multimodal"],
                                fwd["logvar_multimodal"], mask)
        kl_total = 0.0
        ll_total = 0.0
        total = 0.0
        for i in range(self.modalities):
            ll = gaussian_ll(xes[i], fwd["recon_means"][i],
                             fwd["recon_logvars"][i], mask)
            kl_total += kl
            ll_total += ll
            total += kl - ll
        return {"total": total, "kl": kl_total, "ll": ll_total}

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

    @torch.no_grad()
    def pred_recon_fused(self, xes, cs, combine: str,
                         eps: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None):
        """The test stage's scoring entry: the encoder kernel per modality,
        fusion in torch, then one decode+deviation kernel per modality, each
        launch covering every fold. Returns (recon_means, deviations) lists,
        [F, B, D_m] and [F, B]; numerically equivalent to pred_recon plus
        reconstruction_deviation on the same eps. Inference only."""
        stats = [enc.fused(xes[i], cs[i]) for i, enc in enumerate(self.enc)]
        fused_mu, fused_logvar = self.fuse(
            torch.stack([mu for mu, _ in stats]),
            torch.stack([lv for _, lv in stats]), combine)
        z = reparameterize(fused_mu, fused_logvar, eps, generator)
        out = [dec.fused_pred_deviation(z, cs[i], xes[i])
               for i, dec in enumerate(self.dec)]
        return [recon for recon, _ in out], [dev for _, dev in out]
