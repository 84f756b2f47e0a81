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

What bounds a pair on an H100 is fp32 FFMA (6 B H D FLOP against a few MB),
and at training shapes as much the host: a step calls the pair once per
modality. On the device the kernels keep every product's sums in registers
and stream W through a cp.async ring (``csrc/tile_product.cuh``); a pair is
three launches (forward, backward, one sum of partials). On the host the
launch plan (grids, splits, shared memory, scratch size) is computed once
per shape (``plan``), the scratch of a shape is allocated once and reused,
the four gradients share one allocation, and the kernels' shared-memory
attribute is set once.

The scratch is shared by every call of one shape on one device, so those
calls must be ordered on one stream, as PyTorch's default stream orders
them: a forward leaves its tickets zero for the next, a backward has read
its partials before the next one writes them.

``fused_decoder_loss_fn`` is the trainers' loss with every modality's mean
head and NLL going through ``decoder_nll`` (JAX decoder_nll.py:221-256).
"""
from __future__ import annotations

import collections
import functools
from typing import NamedTuple

import torch

from ..ops.linear import apply_hidden, apply_linear
from ..ops.losses import gaussian_ll_rows, kl_standard_normal
from . import _build

# shapes whose scratch is kept (a model has one per distinct modality width)
_SCRATCH_SHAPES = 8


def decoder_nll_reference(g: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          lvo: torch.Tensor, x: torch.Tensor,
                          mask: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel pair: sum over valid rows of the
    per-row log-likelihood, divided by n; gradients through autograd."""
    per_row = gaussian_ll_rows(x, apply_linear(w, b, g), lvo)
    return torch.sum(per_row * mask, dim=-1) / n


class Plan(NamedTuple):
    """How csrc/decoder_nll.cu runs one shape. The forward's grid is
    (tiles, fwd_split, folds): a block walks every fwd_split-th 128-wide
    column chunk of its 32-row tile. The backward's is (chunks, bwd_split,
    folds * hblocks): a block walks every bwd_split-th row tile of its
    column chunk. Scratch sizes are in floats: the forward's ``folds``
    tickets and one partial per block; the backward's dg partials
    [chunks, F, B, H] when chunks > 1, then the dW, db and dlvo partials
    [bwd_split, F, D, H + 2] when bwd_split > 1."""
    tiles: int
    chunks: int
    hblocks: int
    fwd_split: int
    bwd_split: int
    fwd_scratch: int
    bwd_scratch: int
    smem: int

    @property
    def fwd_blocks(self) -> int:
        return self.tiles * self.fwd_split

    @property
    def bwd_blocks(self) -> int:
        return self.chunks * self.bwd_split * self.hblocks


@functools.lru_cache(maxsize=64)
def plan(folds: int, rows: int, hidden: int, d: int) -> Plan:
    """The launch plan of one shape; pure Python, the same for the same
    shape. ``fwd_blocks`` and ``bwd_blocks`` are per fold."""
    tiles = -(-rows // _build.TILE_ROWS)
    chunks = -(-d // _build.TILE_COLS)
    hblocks = -(-hidden // _build.TILE_COLS)
    fwd_split = _build.fill_split(tiles * folds, chunks)
    bwd_split = _build.fill_split(chunks * folds * hblocks, tiles)
    bwd_scratch = 0
    if chunks > 1:
        bwd_scratch += chunks * folds * rows * hidden
    if bwd_split > 1:
        bwd_scratch += bwd_split * folds * d * (hidden + 2)
    return Plan(tiles, chunks, hblocks, fwd_split, bwd_split,
                folds + folds * tiles * fwd_split, bwd_scratch,
                _build.decoder_nll_smem(hidden))


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
    p = plan(folds, rows, h, d)
    if p.smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"{name}: hidden width {h} needs {p.smem} B of "
                         f"shared memory, over the {_build.MAX_SMEM_BYTES} B "
                         "limit")
    return p


_scratch: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()


def _scratch_of(p: Plan, shape: tuple, device: torch.device):
    """(forward scratch, backward scratch) of one shape on one device,
    allocated at the shape's first call; the forward's starts zero (its
    tickets) and every launch leaves the tickets zero."""
    key = (shape, device)
    found = _scratch.get(key)
    if found is None:
        found = (torch.zeros(p.fwd_scratch, device=device),
                 torch.empty(p.bwd_scratch, device=device))
        _scratch[key] = found
        if len(_scratch) > _SCRATCH_SHAPES:
            _scratch.popitem(last=False)
    else:
        _scratch.move_to_end(key)
    return found


class DecoderNLL(torch.autograd.Function):
    """ll [F] by the forward kernel; dg, dw, db, dlvo by the backward
    kernel, which recomputes the means tile by tile."""

    @staticmethod
    def forward(ctx, g, w, b, lvo, x, mask, n):
        p = _check(g, w, b, lvo, x, mask, n)
        folds, rows, h = g.shape
        d = w.shape[1]
        scratch, _ = _scratch_of(p, (folds, rows, h, d), g.device)
        ll = torch.empty(folds, device=g.device)
        lib = _build.load_library()
        with _build.current_device_guard(g.device):
            rc = lib.mmnm_decoder_nll_fwd(
                g.data_ptr(), w.data_ptr(), b.data_ptr(), lvo.data_ptr(),
                x.data_ptr(), mask.data_ptr(), n.data_ptr(),
                scratch.data_ptr(), ll.data_ptr(), folds, rows, h, d,
                p.fwd_split, _build.stream_of(g.device))
        _build.check_launch(lib, rc, "decoder_nll forward")
        decoder_nll.launches += 1
        ctx.save_for_backward(g, w, b, lvo, x, mask, n)
        ctx.plan = p
        return ll

    @staticmethod
    def backward(ctx, gbar):
        g, w, b, lvo, x, mask, n = ctx.saved_tensors
        p = ctx.plan
        folds, rows, h = g.shape
        d = w.shape[1]
        # the gradient of a sum over folds arrives expanded from one value
        # (stride 0): the kernel takes the stride, no copy is made
        if (gbar.shape != (folds,) or gbar.dtype != torch.float32
                or gbar.device != g.device):
            raise ValueError("decoder_nll backward: cotangent of shape "
                             f"{tuple(gbar.shape)}, {gbar.dtype} on "
                             f"{gbar.device}")
        _, scratch = _scratch_of(p, (folds, rows, h, d), g.device)
        # dg, dw, db, dlvo back to back in one allocation
        sizes = (g.numel(), w.numel(), b.numel(), b.numel())
        out = torch.empty(sum(sizes), device=g.device)
        dg, dw, db, dlvo = (t.view(like.shape) for t, like in zip(
            torch.split(out, sizes), (g, w, b, lvo)))
        lib = _build.load_library()
        with _build.current_device_guard(g.device):
            rc = lib.mmnm_decoder_nll_bwd(
                g.data_ptr(), w.data_ptr(), b.data_ptr(), lvo.data_ptr(),
                x.data_ptr(), mask.data_ptr(), n.data_ptr(), gbar.data_ptr(),
                gbar.stride(0), dg.data_ptr(), dw.data_ptr(), db.data_ptr(),
                dlvo.data_ptr(),
                scratch.data_ptr(), folds, rows, h, d, p.bwd_split,
                _build.stream_of(g.device))
        _build.check_launch(lib, rc, "decoder_nll backward")
        decoder_nll.launches += 1
        return dg, dw, db, dlvo, None, None, None


def decoder_nll(g: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                lvo: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                n: torch.Tensor) -> torch.Tensor:
    """Returns ll [F], differentiable in g, w, b and lvo. On CUDA the
    forward is one kernel and the backward one kernel plus the sum of its
    partials; ``launches`` counts one per forward and one per backward."""
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
