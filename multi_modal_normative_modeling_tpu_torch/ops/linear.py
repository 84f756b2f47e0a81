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
    return x @ weight.mT + bias.unsqueeze(-2)


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
