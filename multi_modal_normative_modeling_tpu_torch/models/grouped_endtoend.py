"""The end-to-end dual-decoder model, nm-PM-cont, on the width-grouped
packed layout (counterpart of models/grouped_endtoend.py).

EndToEndCVAE (models/endtoend.py) decodes the fused latent through two
banks, health and disease. Given z the banks are independent, so they
stack on one [2M] axis: each decoder layer is one batched product over
every (bank, modality) pair. Within each width group the axis holds the
group's health decoders (grouped order), then its disease decoders, so the
group's target is [x_g | x_g] and its rows split at the group's midpoint.
The encoder is models/grouped.py's.

The classifier head stays the model's own module (``classifier``): it is
one narrow latent MLP with BatchNorm state, and packing it saves nothing.
The packed tree holds the encoder and both banks, fold axis in front,
weights ``[fan_in, fan_out]``:

    {"enc": (models/grouped.py's encoder),
     "dec": {"layers": [{"w" [F, 2M, K, H], "b"}, ...],
             "out": [{"wm" [F, 2G, H0, d_g], "bm", "lvo"}, ...]}}
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..ops.fusion import poe_logvar
from ..ops.linear import add_rows, fold_expand, leaky_relu
from ..ops.losses import (
    HALF_LOG_2PI,
    cross_entropy_logits,
    kl_standard_normal,
    margin_contrastive,
)
from ..ops.shard import part, vary, whole
from .grouped import (
    GroupLayout,
    _stack,
    decode_chain,
    grouped_encode,
    masked_row_mean,
    pack_grouped_encoder,
    unpack_grouped_encoder,
)
from .stacked import _as_tensor

BANKS = ("dec_health", "dec_disease")


class GroupedEndToEnd(GroupLayout):
    """The packed form of EndToEndCVAE's encoders and decoder banks; it
    holds no parameters, and the classifier is given to ``forward``."""

    def __init__(self, input_dim_list: Sequence[int],
                 hidden_dim: Sequence[int], latent_dim: int, c_dim: int,
                 modalities: int, non_linear: bool = True):
        if len(hidden_dim) < 1:
            raise ValueError("at least one hidden layer")
        super().__init__(list(input_dim_list)[:modalities])
        self.hidden_dim = list(hidden_dim)
        self.n_hidden = len(hidden_dim)
        self.latent_dim = latent_dim
        self.c_dim = c_dim
        self.non_linear = non_linear
        # the [2M] decoder axis: per group, its health then its disease
        # entries, both in grouped order
        self.dec_order = [(bank, m) for _, idx in self.groups
                          for bank in BANKS for m in idx]
        self.bounds2 = 2 * self.bounds

    def _act(self):
        return leaky_relu if self.non_linear else (lambda a: a)

    # -- parameter packing --------------------------------------------------
    def pack_params(self, per: dict) -> dict:
        """Fold-stacked EndToEndCVAE tree (JAX layout) -> the packed encoder
        and decoder banks (the classifier and its state are not packed)."""
        order = self.dec_order
        out = []
        for _, idx in self.groups:
            entries = [(bank, m) for bank in BANKS for m in idx]
            out.append({
                "wm": _stack([per[b][m]["mean"]["w"] for b, m in entries]),
                "bm": _stack([per[b][m]["mean"]["b"] for b, m in entries]),
                "lvo": _stack([_as_tensor(per[b][m]["logvar_out"])[:, 0]
                               for b, m in entries]),
            })
        return {
            "enc": pack_grouped_encoder(self, per["enc"], self.n_hidden),
            "dec": {
                "layers": [{"w": _stack([per[b][m]["hidden"][l]["w"]
                                         for b, m in order]),
                            "b": _stack([per[b][m]["hidden"][l]["b"]
                                         for b, m in order])}
                           for l in range(self.n_hidden)],
                "out": out,
            },
        }

    def unpack_params(self, packed: dict) -> dict:
        """-> {"enc", "dec_health", "dec_disease"}, fold-stacked
        per-modality trees (JAX layout, torch leaves)."""
        pos = {entry: i for i, entry in enumerate(self.dec_order)}
        d = packed["dec"]
        out = {"enc": unpack_grouped_encoder(self, packed["enc"])}
        for k, bank in enumerate(BANKS):
            out[bank] = []
            for m in range(self.modalities):
                gi, row = self.locate[m]
                # a group's out tensors hold its health rows, then disease
                row += k * len(self.groups[gi][1])
                p = pos[(bank, m)]
                head = d["out"][gi]
                out[bank].append({
                    "hidden": [{"w": lay["w"][:, p], "b": lay["b"][:, p]}
                               for lay in d["layers"]],
                    "mean": {"w": head["wm"][:, row],
                             "b": head["bm"][:, row]},
                    "logvar_out": head["lvo"][:, row, None, :],
                })
        return out

    # -- compute -------------------------------------------------------------
    def forward(self, params, x_groups, c: torch.Tensor, eps: torch.Tensor,
                classifier, train: bool = True,
                mask: Optional[torch.Tensor] = None,
                keep: Optional[Sequence[torch.Tensor]] = None) -> dict:
        """x_groups: one [F, G, B, d] per width group; c [F, B, C]; eps
        [F, B, Z]; ``classifier`` the model's head (models/cvae.py), with
        the step's dropout keep masks ``keep``."""
        act = self._act()
        mus, logvars = grouped_encode(params["enc"], x_groups, c, act,
                                      sizes=self.sizes)
        fused_mu, fused_logvar = poe_logvar(mus.movedim(1, 0),
                                            logvars.movedim(1, 0))
        z = fused_mu + eps.to(fused_mu.dtype) * torch.exp(0.5 * fused_logvar)
        g = whole(decode_chain(params["dec"]["layers"],
                               vary(torch.cat([z, c], dim=2)), act),
                  2 * self.modalities)              # [F, 2M, B, H0]
        means = tuple(
            add_rows(part(g[:, int(self.bounds2[gi]):int(self.bounds2[gi + 1])],
                          2 * n) @ out["wm"], out["bm"])
            for gi, (out, n) in enumerate(zip(params["dec"]["out"],
                                              self.sizes)))
        logits, bn_state = classifier(z, train, mask, keep)
        return {"recon_means": means, "mu": fused_mu, "logvar": fused_logvar,
                "logits": logits, "bn_state": bn_state}

    def loss(self, params, x_groups, fwd: dict, labels: torch.Tensor,
             margin=1.0, weight_contrastive=0.1, weight_kl: float = 0.1,
             weight_rec: float = 0.1,
             mask: Optional[torch.Tensor] = None) -> dict:
        """EndToEndCVAE.loss on the dual-bank layout: each (bank, modality)
        Gaussian ll and deviation from its group's rows, split at the
        group's midpoint into the health and disease halves."""
        recon_h = 0.0
        recon_d = 0.0
        dev_h, dev_d = [], []
        for xg, means, out in zip(x_groups, fwd["recon_means"],
                                  params["dec"]["out"]):
            gg = xg.shape[1]
            sq = (part(torch.cat([xg, xg], dim=1), 2 * gg) - means) ** 2
            lvo = fold_expand(out["lvo"][:, :, None, :], sq.shape)
            ll_rows = torch.sum(-0.5 * sq * torch.exp(-lvo) - 0.5 * lvo
                                - HALF_LOG_2PI, dim=3)      # [F, 2G, B]
            ll_entry = whole(masked_row_mean(ll_rows, mask), 2 * gg)
            recon_h = recon_h - torch.sum(ll_entry[:, :gg], dim=1)
            recon_d = recon_d - torch.sum(ll_entry[:, gg:], dim=1)
            dev = whole(torch.mean(sq, dim=3), 2 * gg)       # [F, 2G, B]
            dev_h.append(dev[:, :gg])
            dev_d.append(dev[:, gg:])
        deviation_h = torch.cat(dev_h, dim=1).mean(dim=1)
        deviation_d = torch.cat(dev_d, dim=1).mean(dim=1)
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

    @torch.no_grad()
    def predict(self, params, x_groups, c, classifier) -> torch.Tensor:
        """Eval-mode classifier logits [F, B, classes] from the fused mean
        (cVAE.py:2202)."""
        mus, logvars = grouped_encode(params["enc"], x_groups, c,
                                      self._act(), sizes=self.sizes)
        fused_mu, _ = poe_logvar(mus.movedim(1, 0), logvars.movedim(1, 0))
        return classifier(fused_mu, train=False)[0]
