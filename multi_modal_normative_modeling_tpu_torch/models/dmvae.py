"""Split-latent family: DMVAE, WeightedDMVAE, mmVAEPlus (counterpart of
models/dmvae.py; cVAE.py:1491-1598, :1620-1747, :1895-2002).

All three share:

  * a two-hidden-layer ReLU encoder per modality that ignores the covariates
    (cVAE.py:1454-1467) and emits latent_dim (mu, logvar);
  * the first s_dim = c_dim latent dims are the modality's private code, the
    other latent_dim - c_dim are shared;
  * the shared code is fused by the PoE over (mu, logvar) of
    ``ops.fusion.poe_logvar`` (cVAE.py:1482-1489);
  * each modality decodes concat(z_shared, mu_private_i), latent_dim wide
    again, through a sigmoid-output MLP (cVAE.py:1469-1480);
  * loss = beta * KL(shared) - sum_m -0.5 * ||x - recon||^2 with beta 1.0
    (DMVAE) or 0.05 (mmVAEPlus); WeightedDMVAE weights each modality's KL
    and SSE terms by a learnable weight instead (cVAE.py:1651, :1692-1708;
    |N(0, 1)| at init, unconstrained afterwards).

With latent_dim <= c_dim (the default ``-H 110 110 10`` against 29
covariates) the reference's slices leave the shared code EMPTY: PoE and KL
run over width 0, the noise is [B, 0], and the model trains as M
autoencoders on the private code. That is reproduced, with a warning.

The module holds every fold of a k-fold model: each weight is [F, out, in],
inputs are [F, B, D_m], and ``weights`` is [F, M]. Module names spell the
JAX parameter tree's paths (``enc.0.trunk.1.weight``, ``dec.0.layers.2.bias``),
which is how ``interop`` converts between the two. The JAX package has no
kernel for this family, and neither has the port.
"""
from __future__ import annotations

import warnings
from typing import List, Optional, Sequence

import torch
from torch import nn

from ..kernels.deviation import reconstruction_deviation
from ..ops.fusion import poe_logvar
from ..ops.linear import FoldLinear
from ..ops.losses import kl_standard_normal, neg_half_sse
from .cvae import reparameterize

BETAS = {"dmvae": 1.0, "weighted": 1.0, "mmvaeplus": 0.05}


class _Encoder(nn.Module):
    def __init__(self, sizes: Sequence[int], latent_dim: int, folds: int,
                 generator, device):
        super().__init__()
        self.trunk = nn.ModuleList(
            FoldLinear(sizes[i], sizes[i + 1], folds, generator, device)
            for i in range(len(sizes) - 1))
        self.mu = FoldLinear(sizes[-1], latent_dim, folds, generator, device)
        self.logvar = FoldLinear(sizes[-1], latent_dim, folds, generator,
                                 device)

    def forward(self, x: torch.Tensor):
        h = x
        for layer in self.trunk:
            h = torch.relu(layer(h))
        return self.mu(h), self.logvar(h)


class _Decoder(nn.Module):
    def __init__(self, sizes: Sequence[int], folds: int, generator, device):
        super().__init__()
        self.layers = nn.ModuleList(
            FoldLinear(sizes[i], sizes[i + 1], folds, generator, device)
            for i in range(len(sizes) - 1))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = z
        for layer in self.layers[:-1]:
            h = torch.relu(layer(h))
        return torch.sigmoid(self.layers[-1](h))


class DMVAEFamily(nn.Module):
    def __init__(self, input_dim_list: Sequence[int],
                 hidden_dim: Sequence[int], latent_dim: int, c_dim: int,
                 modalities: int, variant: str = "dmvae", folds: int = 1,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if variant not in BETAS:
            raise ValueError(f"DMVAEFamily variant {variant!r} is not one "
                             f"of {tuple(BETAS)}")
        if latent_dim <= c_dim:
            warnings.warn(
                f"DMVAE-family with latent_dim={latent_dim} <= c_dim={c_dim}:"
                " shared code is empty (reference-compatible degenerate mode)")
        self.input_dim_list = list(input_dim_list)
        self.hidden_dim = list(hidden_dim)
        self.latent_dim = latent_dim
        self.c_dim = c_dim
        self.s_dim = c_dim
        self.modalities = modalities
        self.variant = variant
        self.beta = BETAS[variant]
        self.folds = folds
        # the noise covers the shared code only (models/dmvae.py:114-115)
        self.noise_dim = max(latent_dim - c_dim, 0)
        self.log_keys = ("total", "kl", "ll")
        h = self.hidden_dim
        self.enc = nn.ModuleList(
            _Encoder([d, h[0], h[1]], latent_dim, folds, generator, device)
            for d in self.input_dim_list[:modalities])
        self.dec = nn.ModuleList(
            _Decoder([latent_dim, h[1], h[0], d], folds, generator, device)
            for d in self.input_dim_list[:modalities])
        if variant == "weighted":
            gen_device = generator.device if generator is not None else "cpu"
            weights = torch.randn((folds, modalities), generator=generator,
                                  device=gen_device).abs()
            self.weights = nn.Parameter(weights.to(device))

    def forward(self, xes: Sequence[torch.Tensor], cs=None,
                combine: str = "poe", eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> dict:
        """Encode, fuse the shared code, reparameterize it (``eps`` [F, B,
        noise_dim]), decode. ``cs`` and ``combine`` are taken and ignored,
        as in the reference."""
        s = self.s_dim
        stats = [enc(xes[i]) for i, enc in enumerate(self.enc)]
        fused_mu, fused_logvar = poe_logvar(
            torch.stack([mu[..., s:] for mu, _ in stats]),
            torch.stack([lv[..., s:] for _, lv in stats]))
        z = reparameterize(fused_mu, fused_logvar, eps, generator)
        recons = [dec(torch.cat([z, stats[i][0][..., :s]], dim=-1))
                  for i, dec in enumerate(self.dec)]
        return {"recon_means": recons, "mu_c": fused_mu,
                "logvar_c": fused_logvar}

    def loss(self, xes: Sequence[torch.Tensor], fwd: dict,
             mask: Optional[torch.Tensor] = None) -> dict:
        """The loss terms per fold, each [F]; ``mask`` [F, B] marks the
        valid rows."""
        kl_one = kl_standard_normal(fwd["mu_c"], fwd["logvar_c"], mask)
        kl = 0.0
        ll = 0.0
        for i in range(self.modalities):
            ll_i = neg_half_sse(xes[i], fwd["recon_means"][i], mask)
            if self.variant == "weighted":
                w = self.weights[:, i]
                kl = kl + kl_one * w
                ll = ll + ll_i * w
            else:
                kl = kl + kl_one
                ll = ll + ll_i
        total = kl - ll if self.variant == "weighted" else kl * self.beta - ll
        return {"total": total, "kl": kl, "ll": ll}

    def pred_recon(self, xes, cs=None, combine: str = "poe",
                   eps: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> List[torch.Tensor]:
        return self.forward(xes, cs, combine, eps, generator)["recon_means"]

    reconstruction_deviation = staticmethod(reconstruction_deviation)
