"""The width-grouped packed cVAE: the pad-free packed-modality layout
(counterpart of models/grouped.py).

``StackedMultimodalCVAE`` (models/stacked.py) pads every modality's
features to the widest one. On a mixed-width cohort (the flagship
UCA-gPoE: three 90-wide ROI blocks and the 270-wide early fusion) that
triples the products of encoder layer 0 and of the decoder's mean head.
This layout groups the modalities by feature width and runs only the
width-dependent products per group, at the group's exact width:

  * encoder layer 0: one batched product per width group, [F, G, B, d + C];
  * decoder mean head and Gaussian ll: one product per group, over exactly
    d features (no column mask).

Everything between (the hidden chains, the mu/logvar heads, the fusion) is
width-uniform and stays one batched product over all modalities, in the
group-concatenated ("grouped") modality order ``perm``. With one distinct
width it is the padded layout without padding.

Every leaf carries the fold axis in front, and the tree keeps the JAX
orientation, weights ``[fan_in, fan_out]``, so a fold's slice is what the
JAX ``pack_params`` returns:

    {"enc": {"layer0": [{"w" [F, G, d_g + C, H0], "b" [F, G, H0]}, ...],
             "layers": [{"w" [F, M, K, H], "b"}, ...],
             "wmu" [F, M, H, Z], "bmu", "wlv", "blv"},
     "dec": {"layers": [{"w" [F, M, K, H], "b"}, ...],
             "out": [{"wm" [F, G, H0, d_g], "bm" [F, G, d_g],
                      "lvo" [F, G, d_g]}, ...]},
     "alpha" [F, M] (grouped order)}

The fusion sums are invariant under the modality permutation, so only the
float accumulation order differs from the per-modality model; mmJSD's
ordered-pair regularizer and every per-modality output go back to the
cohort's modality order (``inv_perm``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.linear import add_rows, fold_expand, leaky_relu
from ..ops.losses import HALF_LOG_2PI, kl_standard_normal, row_count
from ..ops.shard import part, vary, whole
from .stacked import (
    VARIANTS,
    _as_tensor,
    decoder_input,
    neg_mse_rows,
    skeleton_fuse,
    skeleton_total,
)


def width_groups(input_dim_list: Sequence[int]) -> List[Tuple[int, List[int]]]:
    """[(width, [modality indices]), ...] in first-appearance order, so a
    uniform-width cohort keeps its modality order."""
    groups: List[Tuple[int, List[int]]] = []
    for m, d in enumerate(input_dim_list):
        for w, idx in groups:
            if w == d:
                idx.append(m)
                break
        else:
            groups.append((d, [m]))
    return groups


def _stack(xs) -> torch.Tensor:
    """Per-modality leaves [F, ...] -> [F, len(xs), ...]."""
    return torch.stack([_as_tensor(x) for x in xs], dim=1).contiguous()


class GroupLayout:
    """The modality bookkeeping of a width-grouped layout: the groups, the
    grouped order ``perm`` and its inverse, each group's slice of the
    grouped axis (``bounds``) and each modality's (group, row)."""

    def __init__(self, input_dim_list: Sequence[int]):
        self.input_dim_list = list(input_dim_list)
        self.modalities = len(self.input_dim_list)
        self.groups = width_groups(self.input_dim_list)
        self.perm = [m for _, idx in self.groups for m in idx]
        # original modality m sits at grouped position inv_perm[m]
        self.inv_perm = np.argsort(self.perm)
        self.sizes = [len(idx) for _, idx in self.groups]
        self.bounds = np.cumsum([0] + self.sizes)
        self.locate = [None] * self.modalities
        for gi, (_, idx) in enumerate(self.groups):
            for row, m in enumerate(idx):
                self.locate[m] = (gi, row)

    def pack_inputs(self, xes: Sequence) -> Tuple[torch.Tensor, ...]:
        """Per-modality [..., B, D_m] (numpy or torch) -> one [..., G, B, d]
        per width group."""
        return tuple(torch.stack([_as_tensor(xes[m]) for m in idx], dim=-3)
                     for _, idx in self.groups)

    def unpermute(self, stats: torch.Tensor) -> torch.Tensor:
        """[F, M, ...] in grouped order -> the cohort's modality order."""
        return stats[:, torch.as_tensor(self.inv_perm, device=stats.device)]


def pack_grouped_encoder(layout: GroupLayout, enc_list, n_hidden: int,
                         hidden_key: str = "hidden",
                         layers_key: str = "layers") -> dict:
    """Per-modality encoder trees (fold-stacked, JAX layout) -> the grouped
    encoder: layer 0 per width group, the width-uniform layers and heads
    over every modality in grouped order. ``hidden_key`` names the
    per-modality hidden list and ``layers_key`` the packed one (the DMVAE
    family calls both 'trunk')."""
    pi = layout.perm
    return {
        "layer0": [{"w": _stack([enc_list[m][hidden_key][0]["w"]
                                 for m in idx]),
                    "b": _stack([enc_list[m][hidden_key][0]["b"]
                                 for m in idx])}
                   for _, idx in layout.groups],
        layers_key: [{"w": _stack([enc_list[m][hidden_key][l]["w"]
                                 for m in pi]),
                    "b": _stack([enc_list[m][hidden_key][l]["b"]
                                 for m in pi])}
                   for l in range(1, n_hidden)],
        **{k: _stack([enc_list[m][head][leaf] for m in pi])
           for k, head, leaf in (("wmu", "mu", "w"), ("bmu", "mu", "b"),
                                 ("wlv", "logvar", "w"),
                                 ("blv", "logvar", "b"))},
    }


def unpack_grouped_encoder(layout: GroupLayout, e: dict,
                           hidden_key: str = "hidden",
                           layers_key: str = "layers") -> list:
    """Inverse of pack_grouped_encoder -> per-modality encoder trees."""
    enc = []
    for m in range(layout.modalities):
        gi, row = layout.locate[m]
        p = int(layout.inv_perm[m])
        hidden = [{"w": e["layer0"][gi]["w"][:, row],
                   "b": e["layer0"][gi]["b"][:, row]}]
        hidden += [{"w": lay["w"][:, p], "b": lay["b"][:, p]}
                   for lay in e[layers_key]]
        enc.append({
            hidden_key: hidden,
            "mu": {"w": e["wmu"][:, p], "b": e["bmu"][:, p]},
            "logvar": {"w": e["wlv"][:, p], "b": e["blv"][:, p]},
        })
    return enc


def grouped_encode(e: dict, x_groups, c: Optional[torch.Tensor], act,
                   layers_key: str = "layers",
                   sizes: Optional[Sequence[int]] = None):
    """The grouped encoder: layer 0 per width group on [x | c] (x alone
    when ``c`` is None), then the width-uniform chain and the heads over
    every modality. Returns (mus, logvars), [F, M, B, Z] in grouped
    order. Under ops.shard.modality_shard each product runs on this
    rank's part of its leaves' modality axis (a group's, of the groups'
    ``sizes``, or every modality's), and the statistics come back whole."""
    hs = []
    if sizes is None:
        sizes = [xg.shape[1] for xg in x_groups]
    for xg, lay0, n in zip(x_groups, e["layer0"], sizes):
        xg = part(xg, n)
        h = xg if c is None else torch.cat(
            [xg, c[:, None].expand(-1, xg.shape[1], -1, -1)], dim=3)
        hs.append(whole(act(add_rows(h @ lay0["w"], lay0["b"])), n))
    h = torch.cat(hs, dim=1)                       # [F, M, B, H0]
    m = h.shape[1]
    h = part(h, m)
    for lay in e[layers_key]:
        h = act(add_rows(h @ lay["w"], lay["b"]))
    return (whole(add_rows(h @ e["wmu"], e["bmu"]), m),
            whole(add_rows(h @ e["wlv"], e["blv"]), m))


def decode_chain(layers, z_in: torch.Tensor, act) -> torch.Tensor:
    """The width-uniform decoder chain over every modality: ``z_in``
    [F, B, K] shared by every modality, or [F, M, B, K]."""
    g = (z_in if z_in.dim() == 4
         else decoder_input(z_in, layers[0]["w"].shape[1]))
    for lay in layers:
        g = act(add_rows(g @ lay["w"], lay["b"]))
    return g


def masked_row_mean(rows: torch.Tensor, mask) -> torch.Tensor:
    """[F, G, B] -> [F, G], the mean over each fold's valid rows."""
    if mask is None:
        return torch.mean(rows, dim=2)
    w = mask.to(rows.dtype)
    return (torch.sum(rows * w[:, None, :], dim=2)
            / torch.clamp(row_count(w), min=1.0)[:, None])


def gaussian_ll_groups(x_groups, means, lvos, mask,
                       sizes: Optional[Sequence[int]] = None
                       ) -> torch.Tensor:
    """Per-modality Gaussian ll over each group's exact width, [F, M] in
    grouped order: ``lvos`` one [F, G, d] per group (this rank's part of
    each group of ``sizes`` under ops.shard.modality_shard)."""
    if sizes is None:
        sizes = [xg.shape[1] for xg in x_groups]
    ll = []
    for xg, mg, lvo, n in zip(x_groups, means, lvos, sizes):
        lvo = fold_expand(lvo[:, :, None, :], mg.shape)
        rows = torch.sum(-0.5 * (part(xg, n) - mg) ** 2 * torch.exp(-lvo)
                         - 0.5 * lvo - HALF_LOG_2PI, dim=3)
        ll.append(whole(masked_row_mean(rows, mask), n))
    return torch.cat(ll, dim=1)


class GroupedStackedCVAE(GroupLayout):
    """The pad-free width-grouped form of the MultimodalCVAE skeleton, for
    cvae, mmjsd, mvtcae and nmmlp (the fusion and the loss composition are
    models/stacked.py's). It holds no parameters: ``forward`` and ``loss``
    take the packed tree."""

    def __init__(self, input_dim_list: Sequence[int],
                 hidden_dim: Sequence[int], latent_dim: int, c_dim: int,
                 modalities: int, non_linear: bool = True,
                 variant: str = "cvae", jsd_on_fused: bool = True):
        if len(hidden_dim) < 1:
            raise ValueError("at least one hidden layer")
        if variant not in VARIANTS:
            raise ValueError(f"grouped variant {variant!r} is not one of "
                             f"{VARIANTS}")
        super().__init__(list(input_dim_list)[:modalities])
        self.variant = variant
        self.jsd_on_fused = jsd_on_fused
        self.hidden_dim = list(hidden_dim)
        self.n_hidden = len(hidden_dim)
        self.latent_dim = latent_dim
        self.c_dim = c_dim
        self.non_linear = non_linear

    # -- parameter packing --------------------------------------------------
    def pack_params(self, per: dict) -> dict:
        """Fold-stacked per-modality tree (JAX layout) -> the grouped tree."""
        pi = self.perm
        dec = per["dec"]
        return {
            "enc": pack_grouped_encoder(self, per["enc"], self.n_hidden),
            "dec": {
                "layers": [{"w": _stack([dec[m]["hidden"][l]["w"]
                                         for m in pi]),
                            "b": _stack([dec[m]["hidden"][l]["b"]
                                         for m in pi])}
                           for l in range(self.n_hidden)],
                "out": [{"wm": _stack([dec[m]["mean"]["w"] for m in idx]),
                         "bm": _stack([dec[m]["mean"]["b"] for m in idx]),
                         "lvo": _stack([_as_tensor(dec[m]["logvar_out"])[:, 0]
                                        for m in idx])}
                        for _, idx in self.groups],
            },
            # alpha in grouped order: the fusion pairs it with the stats
            "alpha": _as_tensor(per["alpha"])[:, pi].contiguous(),
        }

    def unpack_params(self, packed: dict) -> dict:
        """The grouped tree -> the fold-stacked per-modality tree (JAX
        layout, torch leaves)."""
        d = packed["dec"]
        dec = []
        for m in range(self.modalities):
            gi, row = self.locate[m]
            p = int(self.inv_perm[m])
            out = d["out"][gi]
            dec.append({
                "hidden": [{"w": lay["w"][:, p], "b": lay["b"][:, p]}
                           for lay in d["layers"]],
                "mean": {"w": out["wm"][:, row], "b": out["bm"][:, row]},
                "logvar_out": out["lvo"][:, row, None, :],
            })
        return {"enc": unpack_grouped_encoder(self, packed["enc"]),
                "dec": dec, "alpha": self.unpermute(packed["alpha"])}

    # -- compute -------------------------------------------------------------
    def _act(self):
        return leaky_relu if self.non_linear else (lambda a: a)

    def forward(self, params, x_groups, c: torch.Tensor, combine: str,
                eps: torch.Tensor) -> dict:
        """x_groups: one [F, G, B, d] per width group; c [F, B, C]; eps
        [F, B, Z]. recon_means come back per group, [F, G, B, d]."""
        act = self._act()
        m = self.modalities
        mus, logvars = grouped_encode(params["enc"], x_groups, c, act,
                                      sizes=self.sizes)
        fused_mu, fused_logvar = skeleton_fuse(
            self.variant, {"alpha": whole(params["alpha"], m)}, mus, logvars,
            combine)
        z = fused_mu + eps.to(fused_mu.dtype) * torch.exp(0.5 * fused_logvar)
        d = params["dec"]
        g = whole(decode_chain(d["layers"], vary(torch.cat([z, c], dim=2)),
                               act), m)
        means = tuple(
            add_rows(part(g[:, int(self.bounds[gi]):int(self.bounds[gi + 1])],
                          n) @ out["wm"], out["bm"])
            for gi, (out, n) in enumerate(zip(d["out"], self.sizes)))
        return {
            "recon_means": means,
            "mu_multimodal": fused_mu,
            "logvar_multimodal": fused_logvar,
            "mus": mus,
            "logvars": logvars,
            "z": z,
        }

    def loss(self, params, x_groups, fwd: dict,
             mask: Optional[torch.Tensor] = None) -> dict:
        """The padded layout's loss with each group's ll over exactly its
        width; the regularizers see the statistics in the cohort's order."""
        if self.variant == "nmmlp":
            ll = torch.cat([
                whole(neg_mse_rows(
                    (part(xg, n) - mg) ** 2,
                    torch.full((mg.shape[1],), float(xg.shape[3]),
                               dtype=mg.dtype, device=mg.device), mask), n)
                for xg, mg, n in zip(x_groups, fwd["recon_means"],
                                     self.sizes)], dim=1)
        else:
            ll = gaussian_ll_groups(x_groups, fwd["recon_means"],
                                    [o["lvo"] for o in params["dec"]["out"]],
                                    mask, self.sizes)
        mu, logvar = fwd["mu_multimodal"], fwd["logvar_multimodal"]
        kl = kl_standard_normal(mu, logvar, mask)
        mus, logvars = fwd.get("mus"), fwd.get("logvars")
        if mus is not None:
            mus, logvars = self.unpermute(mus), self.unpermute(logvars)
        return skeleton_total(self.variant, self.modalities, kl, ll, mu,
                              logvar, mus, logvars, mask, self.jsd_on_fused)

    def pred_recon(self, params, x_groups, c, combine: str, eps):
        return self.forward(params, x_groups, c, combine, eps)["recon_means"]

    def reconstruction_deviation(self, x_groups, recons) -> torch.Tensor:
        """Per-modality per-subject MSE, [F, M, B] in grouped order."""
        return torch.cat([torch.mean((xg - rg) ** 2, dim=3)
                          for xg, rg in zip(x_groups, recons)], dim=1)
