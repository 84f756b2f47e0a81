"""The plain reference: the multimodal conditional VAE with gPoE fusion,
its loss and Adam, in plain PyTorch (fp32, TF32 off), written from the
model's equations and nothing of the program.

Model (one fold; every fold runs the same equations on its own weights,
batched on a leading fold axis):

    encoder m:  h = [x_m | c];  h = leaky_relu(h W + b, 0.01) per hidden
                layer;  mu_m = h W_mu + b_mu,  logvar_m = h W_lv + b_lv
    gPoE:       w = softmax(alpha) over the modalities,
                P = sum_m w_m exp(-logvar_m),  var = 1 / P,
                mu = var * sum_m w_m exp(-logvar_m) mu_m
    sample:     z = mu + eps * exp(logvar / 2),  logvar = log var
    decoder m:  g = [z | c];  g = leaky_relu(g W + b) per hidden layer
                (the encoder's widths reversed);  mean_m = g W_m + b_m
    loss:       KL = mean_rows(-1/2 sum_z (1 + logvar - mu^2 - exp logvar))
                ll_m = mean_rows(sum_d (-(x - mean)^2 exp(-lvo) / 2
                                        - lvo / 2 - log(2 pi) / 2))
                total = M KL - sum_m ll_m   (logged: total, M KL, sum ll_m)

The means over rows are over a batch's real rows. Adam is b1 0.9, b2
0.999, eps 1e-8 outside the square root, bias-corrected, at a constant
learning rate, one step count for every fold (every fold of a job has as
many rows, so each takes every step); the logs are each epoch's
first-batch terms before its update.

``tf32`` computes every product in TF32 (the control): each operand
rounded to TF32's 10-bit mantissa, the sums in fp32, as the tensor cores
compute a TF32 product. (The card's own TF32 switch leaves the choice of
kernel to cuBLAS, which runs some of these small products without the
tensor cores, so it does not always lower the precision.)
``half_batch`` leaves the second half of every batch out of the loss and
its gradient, the mean taken over the rest, and ``frozen`` makes every
step leave the parameters as they were (faults the comparison has to
catch).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import torch

HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to nearest-even at TF32's 10 mantissa bits."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class _RoundTF32(torch.autograd.Function):
    """Rounding whose gradient passes straight through, as the products'
    inputs are rounded in the backward too."""

    @staticmethod
    def forward(ctx, t):
        return _round_tf32(t)

    @staticmethod
    def backward(ctx, g):
        return _round_tf32(g)


class Reference:
    def __init__(self, cfg: dict, tf32: bool = False,
                 half_batch: bool = False, frozen: bool = False):
        self.dims = list(cfg["input_dim_list"])
        self.c_dim = cfg["c_dim"]
        self.combine = cfg["combine"]
        if self.combine != "gpoe":
            raise ValueError(f"the reference fuses by gpoe, not "
                             f"{self.combine!r}")
        self.tf32 = tf32
        self.half_batch = half_batch
        self.frozen = frozen

    @staticmethod
    @contextlib.contextmanager
    def precision(device):
        """fp32 products: the card's TF32 switch off."""
        if torch.device(device).type != "cuda":
            yield
            return
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            return _RoundTF32.apply(a) @ _RoundTF32.apply(w)
        return a @ w

    def dense(self, layer: dict, h: torch.Tensor) -> torch.Tensor:
        return self.mm(h, layer["w"]) + layer["b"][:, None, :]

    # ---- the model ---------------------------------------------------------
    def forward(self, tree: dict, xs: Sequence[torch.Tensor],
                c: torch.Tensor, eps: torch.Tensor) -> dict:
        """xs per modality [F, B, D_m], c [F, B, C], eps [F, B, Z]."""
        act = torch.nn.functional.leaky_relu
        mus, logvars = [], []
        for enc, x in zip(tree["enc"], xs):
            h = torch.cat([x, c], dim=2)
            for layer in enc["hidden"]:
                h = act(self.dense(layer, h), 0.01)
            mus.append(self.dense(enc["mu"], h))
            logvars.append(self.dense(enc["logvar"], h))
        weights = torch.softmax(tree["alpha"], dim=1)          # [F, M]
        prec = [weights[:, m, None, None] * torch.exp(-lv)
                for m, lv in enumerate(logvars)]
        total_prec = sum(prec)
        var = 1.0 / total_prec
        mu = var * sum(p * m for p, m in zip(prec, mus))
        logvar = torch.log(var)
        z = mu + eps * torch.exp(0.5 * logvar)
        g0 = torch.cat([z, c], dim=2)
        means = []
        for dec in tree["dec"]:
            g = g0
            for layer in dec["hidden"]:
                g = act(self.dense(layer, g), 0.01)
            means.append(self.dense(dec["mean"], g))
        return {"mu": mu, "logvar": logvar, "means": means}

    def loss(self, tree: dict, xs, fwd: dict, mask: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
        """Terms per fold [F] over the rows ``mask`` [F, B] marks."""
        n = torch.clamp(mask.sum(1), min=1.0)

        def row_mean(per_row):
            return (per_row * mask).sum(1) / n

        mu, logvar = fwd["mu"], fwd["logvar"]
        kl = row_mean(-0.5 * torch.sum(1.0 + logvar - mu ** 2
                                       - torch.exp(logvar), dim=2))
        ll = 0.0
        for dec, x, mean in zip(tree["dec"], xs, fwd["means"]):
            lvo = dec["logvar_out"]                             # [F, 1, D]
            ll = ll + row_mean(torch.sum(
                -0.5 * (x - mean) ** 2 * torch.exp(-lvo) - 0.5 * lvo
                - HALF_LOG_2PI, dim=2))
        m = len(xs)
        return {"total": m * kl - ll, "kl": m * kl, "ll": ll}

    # ---- training ----------------------------------------------------------
    def train_job(self, tree: dict, xs: Sequence[torch.Tensor],
                  c: torch.Tensor, eps: torch.Tensor, epochs: int,
                  batch_size: int, lr: float):
        """Train every fold from ``tree`` on xs per modality [F, N, D_m] and
        c [F, N, C] (rows in order, batches of ``batch_size``, a ragged
        last batch masked) with the noise eps [epochs * NB, F, B, Z].
        Returns (trained tree, logs {total,
        kl, ll: [F, epochs begun]}, the first step's gradient {leaf path:
        [F, ...]})."""
        with self.precision(xs[0].device):
            return self._train_job(tree, xs, c, eps, epochs, batch_size, lr)

    def _train_job(self, tree, xs, c, eps, epochs, batch_size, lr):
        from ..inputs import tree_map

        params = tree_map(lambda t: t.detach().clone().requires_grad_(),
                          tree)
        leaves = _leaves(params)
        # torch's Adam is the same update: lr m_hat / (sqrt(v_hat) + eps)
        adam = torch.optim.Adam(leaves, lr=lr, betas=(B1, B2), eps=ADAM_EPS,
                                foreach=True)
        folds, n = c.shape[0], c.shape[1]
        nb = -(-n // batch_size)
        logs = {k: [] for k in ("total", "kl", "ll")}
        first_grad = None
        t = 0
        for _ in range(epochs):
            for i in range(nb):
                lo, hi = i * batch_size, min(n, (i + 1) * batch_size)
                bx = [_rows(x, lo, hi, batch_size) for x in xs]
                bc = _rows(c, lo, hi, batch_size)
                mask = torch.zeros((folds, batch_size), device=c.device)
                keep = hi - lo
                if self.half_batch:
                    keep = max(1, keep // 2)
                mask[:, :keep] = 1.0
                fwd = self.forward(params, bx, bc, eps[t])
                terms = self.loss(params, bx, fwd, mask)
                if i == 0:
                    for k in logs:
                        logs[k].append(terms[k].detach())
                adam.zero_grad(set_to_none=True)
                terms["total"].sum().backward()
                if first_grad is None:
                    first_grad = [p.grad.detach().clone() for p in leaves]
                if not self.frozen:
                    adam.step()
                t += 1
        trained = tree_map(lambda p: p.detach(), params)
        host_logs = {k: torch.stack(v, dim=1).cpu() for k, v in logs.items()}
        return trained, host_logs, _unflatten(tree, first_grad)


def _rows(t: torch.Tensor, lo: int, hi: int, size: int) -> torch.Tensor:
    """Rows lo:hi of t [F, N, W], zero-padded to ``size`` rows."""
    block = t[:, lo:hi]
    if hi - lo < size:
        block = torch.nn.functional.pad(block, (0, 0, 0, size - (hi - lo)))
    return block


def _leaves(tree) -> List[torch.Tensor]:
    from ..inputs import tree_leaves

    return [t for _, t in tree_leaves(tree)]


def _unflatten(like, flat: Optional[List[torch.Tensor]]):
    """``flat`` (in tree_leaves order) in the shape of the tree ``like``."""
    from ..inputs import tree_leaves

    if flat is None:
        return None
    out = {}
    for (path, _), t in zip(tree_leaves(like), flat):
        out[path] = t
    return out
