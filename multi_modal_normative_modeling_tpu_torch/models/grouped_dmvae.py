"""The split-latent DMVAE family on the width-grouped packed layout
(counterpart of models/grouped_dmvae.py).

DMVAE, WeightedDMVAE and mmVAEPlus (models/dmvae.py) share one skeleton:
a two-layer ReLU encoder per modality that ignores the covariates, a
private/shared split of the latent code at s_dim = c_dim, the PoE over the
shared code, and a sigmoid decoder per modality fed [z_shared |
mu_private]. The width-dependent products (encoder layer 0, the decoder's
output layer and its squared error) run per width group at exact width;
the rest is one batched product over every modality in grouped order.

Every leaf carries the fold axis in front, weights ``[fan_in, fan_out]``:

    {"enc": {"layer0": [{"w" [F, G, d_g, h0], "b"}, ...],
             "trunk": [{"w" [F, M, h0, h1], "b"}],
             "wmu" [F, M, h1, Z], "bmu", "wlv", "blv"},
     "dec": {"layers": [{"w" [F, M, K, H], "b"}, ...],
             "out": [{"w" [F, G, h0, d_g], "b" [F, G, d_g]}, ...]},
     "weights" [F, M] (WeightedDMVAE only, grouped order)}

With latent_dim <= c_dim the shared code is empty, as in the per-modality
model (which warns when it is built): the PoE and the KL run over width 0
and the noise is [F, B, 0].
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..ops.fusion import poe_logvar
from ..ops.losses import kl_standard_normal
from .dmvae import BETAS
from .grouped import (
    GroupLayout,
    _stack,
    decode_chain,
    grouped_encode,
    pack_grouped_encoder,
    unpack_grouped_encoder,
)
from .stacked import _as_tensor


class GroupedDMVAE(GroupLayout):
    """The packed form of DMVAEFamily; it holds no parameters."""

    def __init__(self, input_dim_list: Sequence[int],
                 hidden_dim: Sequence[int], latent_dim: int, c_dim: int,
                 modalities: int, variant: str = "dmvae"):
        if variant not in BETAS:
            raise ValueError(f"GroupedDMVAE variant {variant!r} is not one "
                             f"of {tuple(BETAS)}")
        super().__init__(list(input_dim_list)[:modalities])
        self.hidden_dim = list(hidden_dim)
        self.latent_dim = latent_dim
        self.c_dim = c_dim
        self.s_dim = c_dim
        self.variant = variant
        self.beta = BETAS[variant]

    # -- parameter packing --------------------------------------------------
    def pack_params(self, per: dict) -> dict:
        """Fold-stacked DMVAEFamily tree (JAX layout) -> the grouped tree.
        The depths are the model's (a two-layer trunk, a three-layer
        decoder, whatever ``hidden_dim``'s length)."""
        pi = self.perm
        dec = per["dec"]
        n_dec = len(dec[pi[0]]["layers"])
        packed = {
            "enc": pack_grouped_encoder(self, per["enc"],
                                        len(per["enc"][pi[0]]["trunk"]),
                                        hidden_key="trunk",
                                        layers_key="trunk"),
            "dec": {
                "layers": [{"w": _stack([dec[m]["layers"][l]["w"]
                                         for m in pi]),
                            "b": _stack([dec[m]["layers"][l]["b"]
                                         for m in pi])}
                           for l in range(n_dec - 1)],
                "out": [{"w": _stack([dec[m]["layers"][-1]["w"]
                                      for m in idx]),
                         "b": _stack([dec[m]["layers"][-1]["b"]
                                      for m in idx])}
                        for _, idx in self.groups],
            },
        }
        if self.variant == "weighted":
            packed["weights"] = _as_tensor(per["weights"])[:, pi].contiguous()
        return packed

    def unpack_params(self, packed: dict) -> dict:
        d = packed["dec"]
        dec = []
        for m in range(self.modalities):
            gi, row = self.locate[m]
            p = int(self.inv_perm[m])
            layers = [{"w": lay["w"][:, p], "b": lay["b"][:, p]}
                      for lay in d["layers"]]
            layers.append({"w": d["out"][gi]["w"][:, row],
                           "b": d["out"][gi]["b"][:, row]})
            dec.append({"layers": layers})
        out = {"enc": unpack_grouped_encoder(self, packed["enc"],
                                             hidden_key="trunk",
                                             layers_key="trunk"),
               "dec": dec}
        if self.variant == "weighted":
            out["weights"] = self.unpermute(packed["weights"])
        return out

    # -- compute -------------------------------------------------------------
    def forward(self, params, x_groups, eps: torch.Tensor) -> dict:
        """x_groups: one [F, G, B, d] per width group; eps [F, B, Z - s]."""
        mus, logvars = grouped_encode(params["enc"], x_groups, None,
                                      torch.relu, layers_key="trunk")
        s = self.s_dim
        fused_mu, fused_logvar = poe_logvar(mus[..., s:].movedim(1, 0),
                                            logvars[..., s:].movedim(1, 0))
        z = fused_mu + eps.to(fused_mu.dtype) * torch.exp(0.5 * fused_logvar)
        # each modality decodes [z | its private mean]: [F, M, B, Z]
        z_comb = torch.cat([z[:, None].expand(-1, self.modalities, -1, -1),
                            mus[..., :s]], dim=3)
        g = decode_chain(params["dec"]["layers"], z_comb, torch.relu)
        recons = tuple(
            torch.sigmoid(g[:, int(self.bounds[gi]):int(self.bounds[gi + 1])]
                          @ out["w"] + out["b"][:, :, None, :])
            for gi, out in enumerate(params["dec"]["out"]))
        return {"recon_means": recons, "mu_c": fused_mu,
                "logvar_c": fused_logvar}

    def loss(self, params, x_groups, fwd: dict,
             mask: Optional[torch.Tensor] = None) -> dict:
        """DMVAEFamily.loss on the grouped layout: the beta-weighted shared
        KL minus the per-modality -0.5 * SSE (WeightedDMVAE scales both by
        its weights, in grouped order like the ll)."""
        kl_one = kl_standard_normal(fwd["mu_c"], fwd["logvar_c"], mask)
        rows = torch.cat([-0.5 * torch.sum((xg - rg) ** 2, dim=3)
                          for xg, rg in zip(x_groups, fwd["recon_means"])],
                         dim=1)                     # [F, M, B]
        if mask is None:
            ll_m = torch.mean(rows, dim=2)
        else:
            w = mask.to(rows.dtype)[:, None, :]
            ll_m = (torch.sum(rows * w, dim=2)
                    / torch.clamp(torch.sum(w, dim=2), min=1.0))
        if self.variant == "weighted":
            wts = params["weights"]
            kl = kl_one * torch.sum(wts, dim=1)
            ll = torch.sum(ll_m * wts, dim=1)
            total = kl - ll
        else:
            kl = kl_one * self.modalities
            ll = torch.sum(ll_m, dim=1)
            total = kl * self.beta - ll
        return {"total": total, "kl": kl, "ll": ll}

    def pred_recon(self, params, x_groups, eps):
        return self.forward(params, x_groups, eps)["recon_means"]

    def reconstruction_deviation(self, x_groups, recons) -> torch.Tensor:
        """Per-modality per-subject MSE, [F, M, B] in grouped order."""
        return torch.cat([torch.mean((xg - rg) ** 2, dim=3)
                          for xg, rg in zip(x_groups, recons)], dim=1)
