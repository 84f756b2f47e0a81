"""Linear layers with a leading fold axis (counterpart of ops/linear.py).

Initialization reproduces torch ``nn.Linear`` defaults, as the JAX package
does: weight and bias both ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn from
an explicit ``torch.Generator``.

Weights are stored ``[F, fan_out, fan_in]`` (nn.Linear's layout with a fold
axis in front), the layout the CUDA kernels read; the JAX package stores
``[fan_in, fan_out]`` and only ``interop`` converts between the two.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn


def init_linear(fan_in: int, fan_out: int, folds: int = 1,
                generator: Optional[torch.Generator] = None, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (weight [folds, fan_out, fan_in], bias [folds, fan_out]).
    Draws on the generator's device, then moves, so a seed gives the same
    weights on every device."""
    bound = 1.0 / math.sqrt(fan_in)
    gen_device = generator.device if generator is not None else "cpu"

    def uniform(shape):
        u = torch.rand((folds,) + shape, generator=generator,
                       device=gen_device)
        return (u * 2.0 - 1.0) * bound

    w = uniform((fan_out, fan_in))
    b = uniform((fan_out,))
    return w.to(device), b.to(device)


def apply_linear(weight: torch.Tensor, bias: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """``x @ weight^T + bias``; with a fold axis, x [F, B, K], weight
    [F, N, K] and bias [F, N] give [F, B, N]."""
    return add_rows(x @ weight.mT, bias)


def add_rows(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``y + bias`` with ``bias`` [..., N] broadcast over the rows (dim -2)
    of y [..., B, N], its gradient summed over the rows in an order that
    does not depend on the leading dims' sizes (``fold_expand``)."""
    return y + fold_expand(bias.unsqueeze(-2), y.shape)


def fold_expand(t: torch.Tensor, shape) -> torch.Tensor:
    """``t`` broadcast to ``shape``, whose gradient sums the cotangent over
    the broadcast dims in an order that does not depend on how many folds
    are stacked (where autograd records; else the plain broadcast)."""
    if not (torch.is_grad_enabled() and t.requires_grad) \
            or tuple(t.shape) == tuple(shape):
        return t.expand(shape)
    return _FoldExpand.apply(t, tuple(shape))


# the card's reduction kernel gives an output's row a number of threads
# that depends on the number of outputs below 16 (its block height), and
# splits rows longer than 256 values a thread over blocks: sums over at
# least _MIN_OUTPUTS outputs, in chunks of _CHUNK, add each row in one
# order whatever the number of outputs
_MIN_OUTPUTS, _CHUNK = 16, 4096


def _row_sums(rows: torch.Tensor) -> torch.Tensor:
    """The sum of each row of rows [n, R], in an order that depends on R
    alone."""
    n, r = rows.shape
    if r > _CHUNK:
        rows = torch.nn.functional.pad(rows, (0, -r % _CHUNK))
        return _row_sums(_row_sums(rows.reshape(-1, _CHUNK)).reshape(n, -1))
    if n < _MIN_OUTPUTS:
        rows = torch.cat([rows, rows.new_zeros(_MIN_OUTPUTS - n, r)])
    return rows.sum(-1)[:n]


class _FoldExpand(torch.autograd.Function):
    """``t.expand(shape)`` whose backward sums the cotangent over one
    broadcast dim at a time, each as an inner reduction (``_row_sums``):
    that dim moved last, contiguous, summed. Autograd's own sum over a
    broadcast row axis of an [F, B, N] cotangent is an outer reduction
    whose split of the rows follows F * N: on an H100 the N = 10 latent
    heads' bias gradients differed in the last bits between F = 5 and
    F = 10, and over 200 epochs the trajectories drifted 0.012 apart
    (scripts/torch_fold_stack_probe.py). An inner reduction adds a row's
    elements in one order when the outputs are 16 or more
    (scripts/torch_fold_reduce_probe.py); gPoE's weights (a B * Z sum over
    F * M outputs) and a one-configuration classifier's 2-class head are
    fewer."""

    @staticmethod
    def forward(ctx, t, shape):
        ctx.in_shape = tuple(t.shape)
        lead = len(shape) - t.dim()
        ctx.dims = [i for i in range(len(shape))
                    if i < lead or (t.shape[i - lead] == 1 and shape[i] != 1)]
        return t.expand(shape)

    @staticmethod
    def backward(ctx, grad):
        g = grad
        for d in ctx.dims:
            g = g.transpose(d, -1).contiguous()
            sums = _row_sums(g.reshape(-1, g.shape[-1]))
            g = sums.reshape(g.shape[:-1] + (1,)).transpose(d, -1)
        return g.reshape(ctx.in_shape), None


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """torch F.leaky_relu default (negative_slope=0.01)."""
    return torch.nn.functional.leaky_relu(x, negative_slope=0.01)


def apply_hidden(layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                 h: torch.Tensor, non_linear: bool) -> torch.Tensor:
    """The hidden stack of an encoder or decoder: each (weight, bias) layer,
    followed by LeakyReLU when ``non_linear``."""
    for weight, bias in layers:
        h = apply_linear(weight, bias, h)
        if non_linear:
            h = leaky_relu(h)
    return h


def apply_mlp(layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],
              x: torch.Tensor, activation=None,
              final_activation=None) -> torch.Tensor:
    """Apply a stack of (weight, bias) layers; ``activation`` after every
    layer but the last, ``final_activation`` after the last."""
    h = x
    for i, (weight, bias) in enumerate(layers):
        h = apply_linear(weight, bias, h)
        if i < len(layers) - 1 and activation is not None:
            h = activation(h)
    if final_activation is not None:
        h = final_activation(h)
    return h


def init_mlp(sizes: Sequence[int], folds: int = 1,
             generator: Optional[torch.Generator] = None,
             device=None) -> nn.ModuleList:
    """A stack of fold-stacked linear layers for the given layer sizes,
    each layer's weight [F, sizes[i + 1], sizes[i]]."""
    return nn.ModuleList(
        FoldLinear(sizes[i], sizes[i + 1], folds, generator, device)
        for i in range(len(sizes) - 1))


class FoldLinear(nn.Module):
    """One linear layer per fold: weight [F, out, in], bias [F, out]."""

    def __init__(self, fan_in: int, fan_out: int, folds: int = 1,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        w, b = init_linear(fan_in, fan_out, folds, generator, device)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_linear(self.weight, self.bias, x)

    def pair(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(weight, bias), the operands a kernel takes for this layer."""
        return self.weight, self.bias
