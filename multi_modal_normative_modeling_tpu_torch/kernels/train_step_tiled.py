"""The batch-tiled fused train step (K6), fp32 or bf16 operands.

``TiledFusedTrainStep`` replaces the Pallas kernel
``multi_modal_normative_modeling_tpu/kernels/train_step_tiled.py::
_tiled_kernel`` (via ``TiledFusedTrainStep.loss_and_grads_padded``): the
step of ``FusedTrainStep`` over batch tiles of ``tile_b`` rows, each tile's
gradients summed into the whole batch's. Its optional bf16 path stores the
weight matrices, the batch and the activations in bf16, multiplies bf16
operands with fp32 accumulation, and keeps the fusion, KL, reparam, NLL,
biases and gradient sums in fp32.

On the card it is ``csrc/train_step.cuh`` with bf16 (tensor cores) or fp32
(FFMA) operands and the
weight-gradient row sums split into groups of ``tile_b`` rows (per-group
partials summed in group order). On the CPU its plain version is
``TiledFusedTrainStep.reference``, a torch transcription of the TPU
kernel's tile loop with the same cast points; in fp32 it equals the
autograd plain version of ``FusedTrainStep``.
"""
from __future__ import annotations

import torch

from ..ops.linear import leaky_relu
from ..ops.losses import HALF_LOG_2PI
from .train_step import (
    FusedTrainStep,
    _is_matmul_param,
    _work_dtype,
    launch,
)

# The TPU kernel sized its tile by a VMEM budget (choose_tile,
# VMEM_BUDGET_TILED). On the card the tile only groups the rows of the
# weight-gradient sums: the row-owned passes always run 32-row blocks, and
# the weight-gradient pass already launches one block per 32 x 128 output
# tile per (fold, modality) - about a thousand blocks at flagship and PPMI
# widths for 132 SMs - so more groups only add partial sums. The default
# tile is the reference's whole batch of 256 rows, capped at the batch.
DEFAULT_TILE_B = 256


def _dlrelu(a: torch.Tensor) -> torch.Tensor:
    # lrelu is sign-preserving: a > 0 <=> pre-activation > 0
    return torch.where(a > 0, torch.ones_like(a), torch.full_like(a, 0.01))


class TiledFusedTrainStep(FusedTrainStep):
    """The fused step over batch tiles, on the layout of FusedTrainStep.
    ``compute_dtype`` is torch.float32 or torch.bfloat16."""

    def __init__(self, stacked_model, combine: str, tile_b: int = None,
                 compute_dtype=torch.float32, batch_hint: int = None):
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype {compute_dtype}")
        # fp32: 16 bytes; bf16: one k16 step of the tensor cores' mma
        super().__init__(stacked_model, combine,
                         col_align=4 if compute_dtype == torch.float32
                         else 16)
        self.compute_dtype = compute_dtype
        if tile_b is None:
            tile_b = min(DEFAULT_TILE_B, batch_hint or DEFAULT_TILE_B)
        if tile_b < 1:
            raise ValueError(f"tile_b {tile_b} must be positive")
        self.tile_b = tile_b
        # make_packed_batches / pad_eps round the batch axis to this
        self.row_align = tile_b

    # ---- storage-dtype casts ---------------------------------------------------
    def cast_exec(self, named):
        """Weights in the compute dtype; biases, lvo and alpha fp32."""
        if self.compute_dtype == torch.float32:
            return named
        return {k: (v.to(torch.bfloat16) if _is_matmul_param(k) else v)
                for k, v in named.items()}

    def cast_batch(self, batch: dict) -> dict:
        """x and c in the compute dtype; the rest fp32."""
        if self.compute_dtype == torch.float32:
            return batch
        out = dict(batch)
        out["x"] = batch["x"].to(torch.bfloat16)
        out["c"] = batch["c"].to(torch.bfloat16)
        return out

    # ---- the step ------------------------------------------------------------------
    def _run(self, named, x, c, eps, rm, nvalid):
        """As FusedTrainStep's; the batch rows must be a multiple of
        ``tile_b``, and fp32 operands are cast here."""
        if x.shape[2] % self.tile_b:
            raise ValueError(f"batch rows {x.shape[2]} not a multiple of "
                             f"tile_b {self.tile_b}")
        named = self.cast_exec(named)
        batch = self.cast_batch({"x": x, "c": c})
        x, c = batch["x"], batch["c"]
        if x.device.type == "cpu":
            return self.reference(named, x, c, eps, rm, nvalid) + (None,)
        if x.device.type != "cuda":
            raise ValueError(f"tiled_fused_train_step: no kernel for "
                             f"{x.device}")
        losses, flat = tiled_fused_train_step(self, named, x, c, eps, rm,
                                              nvalid)
        return losses, None, flat

    def reference(self, named, x, c, eps, rm, nvalid):
        """The plain version: a torch transcription of the TPU kernel's
        tile loop (JAX train_step_tiled.py:72-283), every fold at once, on
        the true widths cut out of the padded layout."""
        named = self.strip(named)
        x, c = x[..., :self.D], c[..., :self.C]
        cd = self.compute_dtype
        work = _work_dtype(x)

        def rnd(t):
            return t if cd == torch.float32 else t.to(cd).to(work)

        M, L, Z = self.M, self.L, self.Z
        w = {k: (rnd(v.to(work)) if _is_matmul_param(k) else v.to(work))
             for k, v in named.items()}

        def bias(k):
            return w[k][:, :, None, :]

        folds = x.shape[0]
        n = nvalid.to(work)
        n3 = n[:, None, None]
        cmask = self.model.col_mask(x.device).to(work)[None, :, None, :]
        lvo = w["lvo"][:, :, None, :]
        q = torch.exp(-lvo)
        grads = {k: torch.zeros_like(v) for k, v in w.items()}
        losses = {k: torch.zeros(folds, dtype=work, device=x.device)
                  for k in ("total", "kl", "ll")}
        s = (torch.softmax(w["alpha"], dim=1) if self.combine == "gpoe"
             else torch.ones_like(w["alpha"]))[:, :, None, None]
        for t0 in range(0, x.shape[2], self.tile_b):
            rows = slice(t0, t0 + self.tile_b)
            xt = rnd(x[:, :, rows].to(work))                # [F, M, tb, D]
            ct = rnd(c[:, rows].to(work))                   # [F, tb, C]
            et = eps[:, rows].to(work)
            rm3 = rm[:, rows, None].to(work)                # [F, tb, 1]
            rm4 = rm3[:, None]                              # [F, 1, tb, 1]

            # forward: encoders (activations stored in the compute dtype)
            a = [torch.cat([xt, ct[:, None].expand(-1, M, -1, -1)], dim=3)]
            for l in range(L):
                a.append(rnd(leaky_relu(a[-1] @ w[f"enc_w{l}"]
                                        + bias(f"enc_b{l}"))))
            mus = a[L] @ w["wmu"] + bias("bmu")             # fp32
            lvs = a[L] @ w["wlv"] + bias("blv")

            # fusion (fp32)
            if M == 1:
                mu, lgv = mus[:, 0], lvs[:, 0]
            elif self.combine == "moe":
                mu = mus.sum(1) / M
                var = torch.exp(lvs).sum(1) / M
                lgv = torch.log(var)
            elif self.combine == "mopoe":
                vars_m = torch.exp(lvs)
                ts = 1.0 / vars_m
                tsum = ts.sum(1)
                mu_p = (ts * mus).sum(1) / tsum
                mu = (mus.sum(1) + mu_p) / (M + 1)
                var = (vars_m.sum(1) + 1.0 / tsum) / (M + 1)
                lgv = torch.log(var)
            else:
                ps = s * torch.exp(-lvs)
                P = ps.sum(1)
                mu = (ps * mus).sum(1) / P
                lgv = -torch.log(P)

            # reparameterize + decoders
            half = torch.exp(0.5 * lgv)
            z = mu + et * half
            g = [torch.cat([rnd(z), ct], dim=2)[:, None].expand(
                -1, M, -1, -1)]
            for l in range(L):
                g.append(rnd(leaky_relu(g[-1] @ w[f"dec_w{l}"]
                                        + bias(f"dec_b{l}"))))
            means = g[L] @ w["vm"] + bias("cm")

            # losses and the decoder backward
            kl_rows = -0.5 * torch.sum(1.0 + lgv - mu ** 2 - torch.exp(lgv),
                                       dim=2, keepdim=True)
            kl = torch.sum(kl_rows * rm3, dim=(1, 2)) / n
            diff = xt - means
            ll_elem = -0.5 * diff * diff * q - 0.5 * lvo - HALF_LOG_2PI
            ll = torch.sum(ll_elem * cmask * rm4, dim=(1, 2, 3)) / n
            losses["total"] += M * kl - ll
            losses["kl"] += M * kl
            losses["ll"] += ll

            dmean = -(rm4 * cmask * q * diff) / n3[:, None]
            grads["lvo"] += -torch.sum(
                rm4 * cmask * (0.5 * diff * diff * q - 0.5), dim=2) / n3
            dmean_c = rnd(dmean)
            grads["vm"] += g[L].mT @ dmean_c
            grads["cm"] += dmean.sum(2)
            dg = dmean_c @ w["vm"].mT
            for l in range(L - 1, -1, -1):
                dy = dg * _dlrelu(g[l + 1])
                dy_c = rnd(dy)
                grads[f"dec_w{l}"] += g[l].mT @ dy_c
                grads[f"dec_b{l}"] += dy.sum(2)
                dg = dy_c @ w[f"dec_w{l}"].mT
            dz = dg.sum(1)[:, :, :Z]                       # [F, tb, Z]

            # backward: reparam + KL
            dmu = dz + (M * rm3 * mu) / n3
            dlgv = (0.5 * dz * et * half
                    - 0.5 * M * rm3 * (1.0 - torch.exp(lgv)) / n3)

            # backward: fusion
            if M == 1:
                dmus, dlvs = dmu[:, None], dlgv[:, None]
            elif self.combine == "moe":
                dvar = dlgv / var
                dmus = (dmu / M)[:, None].expand(-1, M, -1, -1)
                dlvs = (dvar / M)[:, None] * torch.exp(lvs)
            elif self.combine == "mopoe":
                dvar = dlgv / var
                dmu_p = dmu / (M + 1)
                dvar_p = dvar / (M + 1)
                dtsum = -dvar_p / (tsum * tsum) - dmu_p * mu_p / tsum
                dt = dmu_p[:, None] * mus / tsum[:, None] + dtsum[:, None]
                dmus = dmu[:, None] / (M + 1) + dmu_p[:, None] * ts \
                    / tsum[:, None]
                dlvs = (dvar[:, None] / (M + 1) - dt * ts * ts) * vars_m
            else:
                dP = -dlgv / P - dmu * mu / P
                dp = dmu[:, None] * mus / P[:, None] + dP[:, None]
                dmus = dmu[:, None] * ps / P[:, None]
                dlvs = -dp * ps
                if self.combine == "gpoe":
                    ds = torch.sum(dp * torch.exp(-lvs), dim=(2, 3))
                    sm = s[:, :, 0, 0]
                    grads["alpha"] += sm * (
                        ds - torch.sum(sm * ds, dim=1, keepdim=True))

            # backward: encoders
            dmu_c, dlv_c = rnd(dmus), rnd(dlvs)
            grads["wmu"] += a[L].mT @ dmu_c
            grads["bmu"] += dmus.sum(2)
            grads["wlv"] += a[L].mT @ dlv_c
            grads["blv"] += dlvs.sum(2)
            da = dmu_c @ w["wmu"].mT + dlv_c @ w["wlv"].mT
            for l in range(L - 1, -1, -1):
                dz_l = da * _dlrelu(a[l + 1])
                dz_c = rnd(dz_l)
                grads[f"enc_w{l}"] += a[l].mT @ dz_c
                grads[f"enc_b{l}"] += dz_l.sum(2)
                if l > 0:
                    da = dz_c @ w[f"enc_w{l}"].mT
        return losses, self.widen(grads)


def tiled_fused_train_step(step: TiledFusedTrainStep, named, x, c, eps, rm,
                           nvalid):
    """K6 on the card: one step in the step's compute dtype, the weight
    gradients summed over groups of ``tile_b`` rows. ``launches`` counts
    the steps."""
    losses, flat, _ = launch(step, named, x, c, eps, rm, nvalid, step.tile_b,
                             step.compute_dtype)
    tiled_fused_train_step.launches += 1
    return losses, flat


tiled_fused_train_step.launches = 0
