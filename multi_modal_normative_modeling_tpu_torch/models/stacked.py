"""The packed-modality cVAE (counterpart of models/stacked.py, variant cvae).

All M modalities sit on one leading axis behind the fold axis: inputs are
zero-padded to the widest modality, x [F, M, B, d_max], parameters are
stacked [F, M, ...], and each layer is one batched product over (fold,
modality). Padded input columns carry zero weights and zero data, so the
math is the per-modality model's; padded entries get zero gradients.

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
from ..ops.linear import leaky_relu
from ..ops.losses import HALF_LOG_2PI, kl_standard_normal

SKELETON_VARIANTS = {"cVAE_multimodal": "cvae"}


def _not_ported(variant: str) -> NotImplementedError:
    return NotImplementedError(
        f"packed variant {variant!r} is not ported yet; see ROADMAP.md, "
        "queue 1 item 'Zoo'")


def skeleton_fuse(variant: str, params, mus: torch.Tensor,
                  logvars: torch.Tensor, combine: str):
    """Fusion of the stacked expert statistics [F, M, B, Z] (the cvae branch
    of the JAX skeleton_fuse); returns (fused_mu, fused_logvar) [F, B, Z]."""
    if variant != "cvae":
        raise _not_ported(variant)
    # the port's fusion ops reduce axis 0 and take alpha [F, M]
    fused_mu, fused_var = fusion.combine_latent(
        mus.movedim(1, 0), torch.exp(logvars.movedim(1, 0)), combine,
        params["alpha"])
    return fused_mu, torch.log(fused_var)


def skeleton_total(variant: str, m_count: int, kl: torch.Tensor,
                   ll: torch.Tensor) -> dict:
    """Loss composition (the cvae branch of the JAX skeleton_total): ``ll``
    is the per-modality ll [F, M], ``kl`` the fused KL [F]."""
    if variant != "cvae":
        raise _not_ported(variant)
    ll_sum = torch.sum(ll, dim=1)
    return {"kl": m_count * kl, "ll": ll_sum, "total": m_count * kl - ll_sum}


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
                 variant: str = "cvae"):
        if len(hidden_dim) < 1:
            raise ValueError("at least one hidden layer")
        if variant != "cvae":
            raise _not_ported(variant)
        self.variant = variant
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
        """list of [F, B, D_m] -> [F, M, B, d_max], zero-padded."""
        xes = [_as_tensor(x) for x in xes]
        return torch.stack([_pad_last(x, self.d_max) for x in xes], dim=1)

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
        every modality); eps [F, B, Z], the reparameterization noise."""
        act = leaky_relu if self.non_linear else (lambda a: a)
        m = self.modalities
        e = params["enc"]
        h = torch.cat([x_packed, c[:, None].expand(-1, m, -1, -1)], dim=3)
        for lay in e["layers"]:
            h = act(h @ lay["w"] + lay["b"][:, :, None, :])
        mus = h @ e["wmu"] + e["bmu"][:, :, None, :]
        logvars = h @ e["wlv"] + e["blv"][:, :, None, :]

        fused_mu, fused_logvar = skeleton_fuse(self.variant, params, mus,
                                               logvars, combine)
        z = fused_mu + eps * torch.exp(0.5 * fused_logvar)

        d = params["dec"]
        g = torch.cat([z, c], dim=2)[:, None]            # [F, 1, B, Z+C]
        for lay in d["layers"]:
            g = act(g @ lay["w"] + lay["b"][:, :, None, :])
        means = g @ d["wm"] + d["bm"][:, :, None, :]
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
        """The cvae ELBO per fold, each term [F]: per-modality Gaussian ll
        over each modality's true features, the fused KL, total = M * KL -
        sum_m ll_m. ``mask`` [F, B] marks the valid rows."""
        col = self.col_mask(x_packed.device)[None, :, None, :]
        lvo = params["dec"]["lvo"][:, :, None, :]          # [F, M, 1, d_max]
        ll_elem = (-0.5 * (x_packed - fwd["recon_means"]) ** 2
                   * torch.exp(-lvo) - 0.5 * lvo - HALF_LOG_2PI) * col
        ll_rows = torch.sum(ll_elem, dim=3)                # [F, M, B]
        if mask is None:
            ll = torch.mean(ll_rows, dim=2)
        else:
            w = mask.to(ll_rows.dtype)[:, None, :]
            ll = (torch.sum(ll_rows * w, dim=2)
                  / torch.clamp(torch.sum(w, dim=2), min=1.0))
        kl = kl_standard_normal(fwd["mu_multimodal"],
                                fwd["logvar_multimodal"], mask)
        return skeleton_total(self.variant, self.modalities, kl, ll)

    def pred_recon(self, params, x_packed, c, combine: str, eps):
        return self.forward(params, x_packed, c, combine, eps)["recon_means"]
