"""Fused decoder mean head + Gaussian NLL: the CUDA kernel pair (forward and
backward) and its plain torch version.

``decoder_nll`` replaces the Pallas op
``multi_modal_normative_modeling_tpu/kernels/decoder_nll.py::decoder_nll``
(``_fwd_kernel`` and ``_bwd_kernel`` under a custom VJP): the masked
Gaussian log-likelihood of x under N(g W^T + b, exp(lvo)), computed without
writing the [F, B, D] means, residuals or their gradient to device memory
(``csrc/decoder_nll.cu``). Here it is a ``torch.autograd.Function`` whose
backward is a kernel too. A CUDA tensor goes to the kernels; a CPU tensor
goes to ``decoder_nll_reference``, whose gradients come from autograd.

Operands are fold-stacked: g [F, B, H] (the last decoder activation),
w [F, D, H] (the mean head, nn.Linear's [out, in] per fold), b [F, D],
lvo [F, 1, D], x [F, B, D], the row mask [F, B] and n [F], which is
max(sum(mask), 1) per fold in every caller. The result is ll [F].

``fused_decoder_loss_fn`` is the trainers' loss with every modality's mean
head and NLL going through ``decoder_nll`` (JAX decoder_nll.py:221-256).
"""
from __future__ import annotations

import math

import torch

from ..ops.linear import apply_hidden, apply_linear
from ..ops.losses import gaussian_ll_rows, kl_standard_normal
from . import _build

# blocks that fill the card once (132 SMs on an H100); the kernels split
# their loop over column chunks or row tiles until a launch has about this
# many blocks
_TARGET_BLOCKS = 132


def decoder_nll_reference(g: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          lvo: torch.Tensor, x: torch.Tensor,
                          mask: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel pair: sum over valid rows of the
    per-row log-likelihood, divided by n; gradients through autograd."""
    per_row = gaussian_ll_rows(x, apply_linear(w, b, g), lvo)
    return torch.sum(per_row * mask, dim=-1) / n


def _split(blocks: int, loop: int) -> int:
    """How many blocks share a loop of `loop` steps, so that `blocks` of
    them fill the card."""
    return max(1, min(loop, math.ceil(_TARGET_BLOCKS / blocks)))


def _check(g, w, b, lvo, x, mask, n):
    name = "decoder_nll"
    if g.dim() != 3:
        raise ValueError(f"{name}: g must be [F, B, H], got {tuple(g.shape)}")
    folds, rows, h = g.shape
    if w.dim() != 3 or w.shape[0] != folds or w.shape[2] != h:
        raise ValueError(f"{name}: w has shape {tuple(w.shape)}, expected "
                         f"[{folds}, D, {h}]")
    d = w.shape[1]
    for t, what, want in ((b, "b", (folds, d)), (lvo, "lvo", (folds, 1, d)),
                          (x, "x", (folds, rows, d)),
                          (mask, "mask", (folds, rows)), (n, "n", (folds,))):
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, "
                             f"expected {list(want)}")
    _build.check_tensors(name, [g, w, b, lvo, x, mask, n], g.device)
    smem = _build.decoder_nll_smem(h)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"{name}: hidden width {h} needs {smem} B of shared "
                         f"memory, over the {_build.MAX_SMEM_BYTES} B limit")
    return folds, rows, h, d


class DecoderNLL(torch.autograd.Function):
    """ll [F] by the forward kernel; dg, dw, db, dlvo by the backward
    kernels, which recompute the means tile by tile."""

    @staticmethod
    def forward(ctx, g, w, b, lvo, x, mask, n):
        folds, rows, h, d = _check(g, w, b, lvo, x, mask, n)
        tiles = -(-rows // _build.TM)
        split = _split(tiles * folds, -(-d // _build.BN))
        part = torch.empty(folds * tiles * split, device=g.device)
        ll = torch.empty(folds, device=g.device)
        lib = _build.load_library()
        with torch.cuda.device(g.device):
            rc = lib.mmnm_decoder_nll_fwd(
                g.data_ptr(), w.data_ptr(), b.data_ptr(), lvo.data_ptr(),
                x.data_ptr(), mask.data_ptr(), n.data_ptr(), part.data_ptr(),
                ll.data_ptr(), folds, rows, h, d, split,
                _build.stream_of(g.device))
        _build.check_launch(lib, rc, "decoder_nll forward")
        decoder_nll.launches += 1
        ctx.save_for_backward(g, w, b, lvo, x, mask, n)
        return ll

    @staticmethod
    def backward(ctx, gbar):
        g, w, b, lvo, x, mask, n = ctx.saved_tensors
        folds, rows, h = g.shape
        d = w.shape[1]
        gbar = gbar.contiguous()
        _build.check_tensors("decoder_nll backward", [gbar], g.device)
        tiles = -(-rows // _build.TM)
        cols = -(-d // _build.BN)
        dg_split = _split(tiles * folds, cols)
        dw_split = _split(cols * folds, tiles)
        dg, dw = torch.empty_like(g), torch.empty_like(w)
        db, dlvo = torch.empty_like(b), torch.empty_like(lvo)
        # per-split partials, summed in split order (unused at split 1)
        dg_part = torch.empty((dg_split if dg_split > 1 else 0,) + g.shape,
                              device=g.device)
        parts = dw_split if dw_split > 1 else 0
        dw_part = torch.empty((parts,) + w.shape, device=g.device)
        db_part = torch.empty((parts,) + b.shape, device=g.device)
        dlvo_part = torch.empty((parts,) + b.shape, device=g.device)
        lib = _build.load_library()
        with torch.cuda.device(g.device):
            rc = lib.mmnm_decoder_nll_bwd(
                g.data_ptr(), w.data_ptr(), b.data_ptr(), lvo.data_ptr(),
                x.data_ptr(), mask.data_ptr(), n.data_ptr(), gbar.data_ptr(),
                dg.data_ptr(), dw.data_ptr(), db.data_ptr(), dlvo.data_ptr(),
                dg_part.data_ptr(), dw_part.data_ptr(), db_part.data_ptr(),
                dlvo_part.data_ptr(), folds, rows, h, d, dg_split, dw_split,
                _build.stream_of(g.device))
        _build.check_launch(lib, rc, "decoder_nll backward")
        decoder_nll.launches += 1
        return dg, dw, db, dlvo, None, None, None


def decoder_nll(g: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                lvo: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                n: torch.Tensor) -> torch.Tensor:
    """Returns ll [F], differentiable in g, w, b and lvo. On CUDA every
    forward and every backward is one launch of its kernel; ``launches``
    counts both."""
    if g.device.type == "cpu":
        return decoder_nll_reference(g, w, b, lvo, x, mask, n)
    if g.device.type != "cuda":
        raise ValueError(f"decoder_nll: no kernel for {g.device}")
    return DecoderNLL.apply(g, w, b, lvo, x, mask, n)


decoder_nll.launches = 0


def fused_decoder_loss_fn(model, config):
    """``loss_fn(batch, eps) -> (total [F], logs)`` for the cvae variant with
    each modality's mean head and NLL fused into ``decoder_nll``; the same
    math as the default loss, total = M * KL - sum_m ll_m (reference
    cVAE.py:1187-1196)."""
    from ..models.cvae import reparameterize

    if getattr(model, "variant", None) != "cvae":
        raise ValueError("fused decoder path supports the 'cvae' variant")
    combine = config.combine
    m_count = model.modalities

    def loss_fn(batch, eps):
        xes, cs, mask = batch["x"], batch["c"], batch["mask"]
        mus, logvars = model.encode_all(xes, cs)
        fmu, flv = model.fuse(mus, logvars, combine)
        z = reparameterize(fmu, flv, eps)
        kl = kl_standard_normal(fmu, flv, mask)
        n = torch.clamp(torch.sum(mask, dim=-1), min=1.0)
        ll_total = 0.0
        for m, dec in enumerate(model.dec):
            h = apply_hidden(dec.hidden_layers(),
                             torch.cat([z, cs[m]], dim=-1), model.non_linear)
            ll_total = ll_total + decoder_nll(
                h, dec.mean.weight, dec.mean.bias, dec.logvar_out, xes[m],
                mask, n)
        total = m_count * kl - ll_total
        return total, {"total": total, "kl": m_count * kl, "ll": ll_total}

    return loss_fn
