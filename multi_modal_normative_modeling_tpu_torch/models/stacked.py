"""The packed-modality cVAE (counterpart of models/stacked.py).

All M modalities sit on one leading axis behind the fold axis: inputs are
zero-padded to the widest modality, x [F, M, B, d_max], parameters are
stacked [F, M, ...], and each layer is one batched product over (fold,
modality). Padded input columns carry zero weights and zero data, so the
math is the per-modality model's; padded entries get zero gradients.

``variant`` covers the cvae skeleton of the zoo (models/multimodal.py):
cvae, mmjsd, mvtcae and nmmlp share the encoder and decoder MLPs and differ
only in the fusion (``skeleton_fuse``) and the loss composition
(``skeleton_total``), which the width-grouped layout (models/grouped.py)
shares.

The packed tree keeps the JAX package's orientation, weights
``[fan_in, fan_out]`` ([F, M, in, out]), so a fold's slice of it is
exactly what the JAX ``pack_params`` returns (tests compare them leaf for
leaf); it is the layout the fused train-step kernels read
(``kernels/train_step.py``):

    {"enc": {"layers": [{"w" [F, M, K_l, H_l], "b" [F, M, H_l]}, ...],
             "wmu" [F, M, H, Z], "bmu" [F, M, Z], "wlv", "blv"},
     "dec": {"layers": [...], "wm" [F, M, H, d_max], "bm" [F, M, d_max],
             "lvo" [F, M, d_max]},
     "alpha" [F, M]}

Encoder layer 0's weight rows are [x block padded to d_max | covariates];
decoder layer 0's are [latent | covariates]. ``pack_params`` takes the
fold-stacked per-modality tree in the JAX layout (what
``interop.params_to_jax(model)`` returns; ``interop.packed_from_model``
does both steps).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import fusion
from ..ops.linear import add_rows, fold_expand, leaky_relu
from ..ops.losses import (
    HALF_LOG_2PI,
    kl_standard_normal,
    pairwise_jsd,
    row_count,
)
from ..ops.shard import part, vary, whole
from .multimodal import MVTCAE_BETA, VARIANTS, total_correlation

# registry name -> packed variant of the cvae-skeleton zoo; the DMVAE
# family packs on its own split-latent layout (models/grouped_dmvae.py)
SKELETON_VARIANTS = {
    "cVAE_multimodal": "cvae",
    "mmJSD": "mmjsd",
    "mvtCAE": "mvtcae",
}


def skeleton_fuse(variant: str, params, mus: torch.Tensor,
                  logvars: torch.Tensor, combine: str):
    """The variant's fusion of the stacked expert statistics [F, M, B, Z],
    branch for branch MultimodalCVAE.fuse (the mvtcae ProductOfExperts2
    quirk and variance clamp included); returns (fused_mu, fused_logvar)
    [F, B, Z]. Every fusion reduces the modality axis with sums, so the
    padded and the width-grouped (permuted) layouts share it."""
    # the port's fusion ops reduce axis 0 and take alpha [F, M]
    mus, logvars = mus.movedim(1, 0), logvars.movedim(1, 0)
    if variant == "mmjsd":
        fused_mu, fused_var = fusion.product_of_experts(mus,
                                                        torch.exp(logvars))
        return fused_mu, torch.log(fused_var)
    variances = torch.exp(logvars)
    if variant == "mvtcae":
        if combine.lower() == "poe":
            fused_mu, fused_var = fusion.poe_logvar(mus, variances)
        else:
            fused_mu, fused_var = fusion.combine_latent(
                mus, variances, combine, params["alpha"],
                single_modality_shortcut=False)
        return fused_mu, torch.log(torch.clamp(fused_var, min=1e-6))
    fused_mu, fused_var = fusion.combine_latent(
        mus, variances, combine, params["alpha"],
        single_modality_shortcut=(variant != "nmmlp"))
    return fused_mu, torch.log(fused_var)


def skeleton_total(variant: str, m_count: int, kl: torch.Tensor,
                   ll: torch.Tensor, mu=None, logvar=None, mus=None,
                   logvars=None, mask: Optional[torch.Tensor] = None,
                   jsd_on_fused: bool = True) -> dict:
    """The variant's loss composition, per fold: ``kl`` the fused KL [F],
    ``ll`` the per-modality ll [F, M]; ``mu``/``logvar`` the fused
    statistics [F, B, Z] and ``mus``/``logvars`` the experts' [F, M, B, Z]
    in the cohort's modality order (mmJSD's pairwise KL runs over ordered
    pairs i < j, so the grouped layout un-permutes before calling)."""
    ll_sum = torch.sum(ll, dim=1)
    out = {"kl": m_count * kl, "ll": ll_sum}
    if variant == "mmjsd":
        if jsd_on_fused:
            stats, lvs = [mu] * m_count, [logvar] * m_count
        else:
            stats = [mus[:, m] for m in range(m_count)]
            lvs = [logvars[:, m] for m in range(m_count)]
        out["jsd"] = jsd = pairwise_jsd(stats, lvs, mask)
        out["total"] = m_count * (kl + jsd) - ll_sum
    elif variant == "mvtcae":
        tc = total_correlation(mus.movedim(1, 0), mask)
        out["tc"] = tc * m_count
        out["total"] = (m_count * kl + 0.00001 * ll_sum
                        + m_count * MVTCAE_BETA * tc)
    else:
        out["total"] = m_count * kl - ll_sum
    return out


def decoder_input(zc: torch.Tensor, m: int) -> torch.Tensor:
    """The decoders' input [F, B, K], shared by every modality, as one copy
    a modality [F, m, B, K]: each decoder layer is then a plain batched
    product per (fold, modality), the same products whatever the number of
    modalities (with a broadcast operand the card's library picks another
    kernel, whose sums differ in the last bits)."""
    return zc[:, None].expand(-1, m, -1, -1).contiguous()


def neg_mse_rows(sq: torch.Tensor, dims: torch.Tensor,
                 mask: Optional[torch.Tensor]) -> torch.Tensor:
    """nm-MLP's ll, -MSE over each modality's true elements: ``sq``
    [F, M, B, d] squared residuals (zero on padded columns), ``dims`` [M]
    the true widths -> [F, M]."""
    if mask is None:
        return -torch.sum(sq, dim=(2, 3)) / (sq.shape[2] * dims)
    w = mask.to(sq.dtype)
    n = torch.clamp(row_count(w), min=1.0)[:, None]
    return -torch.sum(sq * w[:, None, :, None], dim=(2, 3)) / (n * dims)


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def _pad_last(a: torch.Tensor, size: int) -> torch.Tensor:
    return torch.nn.functional.pad(a, (0, size - a.shape[-1]))


class StackedMultimodalCVAE:
    """The packed form of the fold-stacked MultimodalCVAE skeleton. It holds
    no parameters: ``forward`` and ``loss`` take the packed tree."""

    def __init__(self, input_dim_list: Sequence[int],
                 hidden_dim: Sequence[int], latent_dim: int, c_dim: int,
                 modalities: int, non_linear: bool = True,
                 variant: str = "cvae", jsd_on_fused: bool = True):
        if len(hidden_dim) < 1:
            raise ValueError("at least one hidden layer")
        if variant not in VARIANTS:
            raise ValueError(f"packed variant {variant!r} is not one of "
                             f"{VARIANTS}")
        self.variant = variant
        self.jsd_on_fused = jsd_on_fused
        self.input_dim_list = list(input_dim_list)
        self.d_max = max(input_dim_list)
        self.hidden_dim = list(hidden_dim)
        self.n_hidden = len(hidden_dim)
        self.latent_dim = latent_dim
        self.c_dim = c_dim
        self.modalities = modalities
        self.non_linear = non_linear

    # -- parameter packing --------------------------------------------------
    def pack_params(self, per_modality: dict) -> dict:
        """Fold-stacked per-modality tree (JAX layout, leaves [F, ...],
        numpy or torch) -> the packed tree of torch tensors."""
        dm, L = self.d_max, self.n_hidden
        enc_layers = [{"w": [], "b": []} for _ in range(L)]
        dec_layers = [{"w": [], "b": []} for _ in range(L)]
        heads = {k: [] for k in ("wmu", "bmu", "wlv", "blv", "wm", "bm",
                                 "lvo")}
        for m in range(self.modalities):
            e = per_modality["enc"][m]
            d_m = self.input_dim_list[m]
            for l in range(L):
                w = _as_tensor(e["hidden"][l]["w"])
                if l == 0:
                    # rows [x (d_m) | covariates]: pad the x block to d_max
                    # so the covariate rows line up across modalities
                    w = torch.cat([
                        torch.nn.functional.pad(
                            w[:, :d_m], (0, 0, 0, dm - d_m)),
                        w[:, d_m:]], dim=1)
                enc_layers[l]["w"].append(w)
                enc_layers[l]["b"].append(_as_tensor(e["hidden"][l]["b"]))
            heads["wmu"].append(_as_tensor(e["mu"]["w"]))
            heads["bmu"].append(_as_tensor(e["mu"]["b"]))
            heads["wlv"].append(_as_tensor(e["logvar"]["w"]))
            heads["blv"].append(_as_tensor(e["logvar"]["b"]))
            d = per_modality["dec"][m]
            for l in range(L):
                dec_layers[l]["w"].append(_as_tensor(d["hidden"][l]["w"]))
                dec_layers[l]["b"].append(_as_tensor(d["hidden"][l]["b"]))
            heads["wm"].append(_pad_last(_as_tensor(d["mean"]["w"]), dm))
            heads["bm"].append(_pad_last(_as_tensor(d["mean"]["b"]), dm))
            heads["lvo"].append(
                _pad_last(_as_tensor(d["logvar_out"])[:, 0], dm))

        def stack(xs):
            return torch.stack(xs, dim=1).contiguous()

        return {
            "enc": {
                "layers": [{"w": stack(lay["w"]), "b": stack(lay["b"])}
                           for lay in enc_layers],
                **{k: stack(heads[k]) for k in ("wmu", "bmu", "wlv", "blv")},
            },
            "dec": {
                "layers": [{"w": stack(lay["w"]), "b": stack(lay["b"])}
                           for lay in dec_layers],
                **{k: stack(heads[k]) for k in ("wm", "bm", "lvo")},
            },
            "alpha": _as_tensor(per_modality["alpha"]),
        }

    def unpack_params(self, packed: dict) -> dict:
        """The packed tree -> the fold-stacked per-modality tree (JAX
        layout, torch leaves)."""
        out = {"enc": [], "dec": [], "alpha": packed["alpha"]}
        e, dd = packed["enc"], packed["dec"]
        for m in range(self.modalities):
            d = self.input_dim_list[m]
            hidden = []
            for l, lay in enumerate(e["layers"]):
                w = lay["w"][:, m]
                if l == 0:
                    w = torch.cat([w[:, :d], w[:, self.d_max:]], dim=1)
                hidden.append({"w": w, "b": lay["b"][:, m]})
            out["enc"].append({
                "hidden": hidden,
                "mu": {"w": e["wmu"][:, m], "b": e["bmu"][:, m]},
                "logvar": {"w": e["wlv"][:, m], "b": e["blv"][:, m]},
            })
            out["dec"].append({
                "hidden": [{"w": lay["w"][:, m], "b": lay["b"][:, m]}
                           for lay in dd["layers"]],
                "mean": {"w": dd["wm"][:, m, :, :d], "b": dd["bm"][:, m, :d]},
                "logvar_out": dd["lvo"][:, m, None, :d],
            })
        return out

    # -- data packing ----------------------------------------------------------
    def pack_inputs(self, xes: Sequence) -> torch.Tensor:
        """list of [..., B, D_m] -> [..., M, B, d_max], zero-padded."""
        xes = [_as_tensor(x) for x in xes]
        return torch.stack([_pad_last(x, self.d_max) for x in xes], dim=-3)

    def col_mask(self, device=None) -> torch.Tensor:
        """[M, d_max], 1.0 over each modality's true features."""
        mask = torch.zeros(self.modalities, self.d_max, device=device)
        for m, d in enumerate(self.input_dim_list):
            mask[m, :d] = 1.0
        return mask

    # -- compute -----------------------------------------------------------------
    def forward(self, params, x_packed: torch.Tensor, c: torch.Tensor,
                combine: str, eps: torch.Tensor) -> dict:
        """x_packed [F, M, B, d_max]; c [F, B, C] (one covariate block for
        every modality); eps [F, B, Z], the reparameterization noise.
        Under ops.shard.modality_shard the encoders and decoders run on
        this rank's modalities (recon_means holds those) and the fusion on
        the gathered statistics."""
        act = leaky_relu if self.non_linear else (lambda a: a)
        m = self.modalities
        x_packed = part(x_packed, m)
        e = params["enc"]
        h = torch.cat([x_packed,
                       c[:, None].expand(-1, x_packed.shape[1], -1, -1)],
                      dim=3)
        for lay in e["layers"]:
            h = act(add_rows(h @ lay["w"], lay["b"]))
        mus = whole(add_rows(h @ e["wmu"], e["bmu"]), m)
        logvars = whole(add_rows(h @ e["wlv"], e["blv"]), m)

        fused_mu, fused_logvar = skeleton_fuse(
            self.variant, {"alpha": whole(params["alpha"], m)}, mus, logvars,
            combine)
        z = fused_mu + eps.to(fused_mu.dtype) * torch.exp(0.5 * fused_logvar)

        d = params["dec"]
        g = decoder_input(vary(torch.cat([z, c], dim=2)),
                          d["layers"][0]["w"].shape[1])  # [F, M, B, Z+C]
        for lay in d["layers"]:
            g = act(add_rows(g @ lay["w"], lay["b"]))
        means = add_rows(g @ d["wm"], d["bm"])
        return {
            "recon_means": means,                         # [F, M, B, d_max]
            "mu_multimodal": fused_mu,
            "logvar_multimodal": fused_logvar,
            "mus": mus,
            "logvars": logvars,
            "z": z,
        }

    def loss(self, params, x_packed: torch.Tensor, fwd: dict,
             mask: Optional[torch.Tensor] = None) -> dict:
        """The variant's loss per fold, each term [F]: per-modality ll
        (Gaussian, or -MSE for nmmlp) over each modality's true features,
        the fused KL and the variant's regularizer (mmJSD's pairwise KL,
        mvtCAE's TC). ``mask`` [F, B] marks the valid rows."""
        m = self.modalities
        x_packed = part(x_packed, m)
        col = part(self.col_mask(x_packed.device), m, 0)[None, :, None, :]
        sq = (x_packed - fwd["recon_means"]) ** 2
        if self.variant == "nmmlp":
            dims = part(torch.tensor(self.input_dim_list, dtype=sq.dtype,
                                     device=sq.device), m, 0)
            ll = neg_mse_rows(sq * col, dims, mask)
        else:
            lvo = fold_expand(params["dec"]["lvo"][:, :, None, :], sq.shape)
            ll_elem = (-0.5 * sq * torch.exp(-lvo) - 0.5 * lvo
                       - HALF_LOG_2PI) * col
            ll_rows = torch.sum(ll_elem, dim=3)            # [F, M, B]
            if mask is None:
                ll = torch.mean(ll_rows, dim=2)
            else:
                w = mask.to(ll_rows.dtype)
                ll = (torch.sum(ll_rows * w[:, None, :], dim=2)
                      / torch.clamp(row_count(w), min=1.0)[:, None])
        ll = whole(ll, m)
        mu, logvar = fwd["mu_multimodal"], fwd["logvar_multimodal"]
        kl = kl_standard_normal(mu, logvar, mask)
        return skeleton_total(self.variant, self.modalities, kl, ll, mu,
                              logvar, fwd.get("mus"), fwd.get("logvars"),
                              mask, self.jsd_on_fused)

    def pred_recon(self, params, x_packed, c, combine: str, eps):
        return self.forward(params, x_packed, c, combine, eps)["recon_means"]

    def reconstruction_deviation(self, x_packed: torch.Tensor,
                                 recon: torch.Tensor) -> torch.Tensor:
        """Per-modality per-subject MSE over each modality's true features,
        [F, M, B]."""
        col = self.col_mask(x_packed.device)[None, :, None, :]
        dims = torch.tensor(self.input_dim_list, dtype=recon.dtype,
                            device=recon.device)
        return (torch.sum((x_packed - recon) ** 2 * col, dim=3)
                / dims[None, :, None])
