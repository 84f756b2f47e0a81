"""Conditional encoder/decoder modules (counterpart of models/cvae.py).

  Encoder: concat(x, c) -> hidden linears (+LeakyReLU when non_linear) ->
           parallel mu / logvar heads.
  Decoder: concat(z, c) -> reversed hidden linears (+LeakyReLU) -> mean head,
           plus a learnable homoscedastic output logvar initialized to -3
           (cVAE.py:193-194).

Every parameter carries a leading fold axis of size ``folds``: one module
holds all folds of a k-fold model, and inputs are [F, B, ...]. ``forward``
is the plain torch math; ``fused`` runs the same computation through the
CUDA kernel (the plain version on CPU tensors).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from ..kernels import deviation as dev_kernel
from ..kernels import mlp as mlp_kernel
from ..kernels._build import Layer
from ..ops.linear import FoldLinear


class Encoder(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: Sequence[int],
                 latent_dim: int, c_dim: int, non_linear: bool = True,
                 folds: int = 1, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        sizes = [input_dim + c_dim] + list(hidden_dim)
        self.non_linear = non_linear
        self.hidden = nn.ModuleList(
            FoldLinear(sizes[i], sizes[i + 1], folds, generator, device)
            for i in range(len(sizes) - 1))
        self.mu = FoldLinear(sizes[-1], latent_dim, folds, generator, device)
        self.logvar = FoldLinear(sizes[-1], latent_dim, folds, generator,
                                 device)

    def hidden_layers(self) -> List[Layer]:
        return [layer.pair() for layer in self.hidden]

    def forward(self, x: torch.Tensor, c: torch.Tensor):
        """(mu, logvar), each [F, B, Z]."""
        return mlp_kernel.encoder_reference(
            self.hidden_layers(), self.mu.pair(), self.logvar.pair(), x, c,
            self.non_linear)

    def fused(self, x: torch.Tensor, c: torch.Tensor):
        return mlp_kernel.fused_encoder(
            self.hidden_layers(), self.mu.pair(), self.logvar.pair(), x, c,
            self.non_linear)


class Decoder(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: Sequence[int],
                 latent_dim: int, c_dim: int, non_linear: bool = True,
                 folds: int = 1, init_logvar: float = -3.0,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        sizes = [latent_dim + c_dim] + list(hidden_dim)[::-1]
        self.non_linear = non_linear
        self.hidden = nn.ModuleList(
            FoldLinear(sizes[i], sizes[i + 1], folds, generator, device)
            for i in range(len(sizes) - 1))
        self.mean = FoldLinear(sizes[-1], input_dim, folds, generator, device)
        self.logvar_out = nn.Parameter(
            torch.full((folds, 1, input_dim), init_logvar, device=device))

    def hidden_layers(self) -> List[Layer]:
        return [layer.pair() for layer in self.hidden]

    def forward(self, z: torch.Tensor, c: torch.Tensor):
        """(mean [F, B, D], logvar_out [F, 1, D]) of the reconstruction
        Normal."""
        mean = dev_kernel.decode_mean_reference(
            self.hidden_layers(), self.mean.pair(), z, c, self.non_linear)
        return mean, self.logvar_out

    def fused_mean(self, z: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """The reconstruction mean [F, B, D] in one kernel."""
        return dev_kernel.fused_decoder_mean(
            self.hidden_layers(), self.mean.pair(), z, c, self.non_linear)

    def fused_pred_deviation(self, z: torch.Tensor, c: torch.Tensor,
                             x: torch.Tensor):
        """(reconstruction mean [F, B, D], deviation [F, B]) in one kernel."""
        return dev_kernel.fused_pred_deviation(
            self.hidden_layers(), self.mean.pair(), z, c, x, self.non_linear)


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   eps: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """z = mu + eps * exp(0.5 * logvar) (cVAE.py:1130-1133). ``eps`` is
    drawn from ``generator`` (on the generator's device, then moved) unless
    it is given, as tests do to replay the JAX package's draws."""
    if eps is None:
        gen_device = generator.device if generator is not None else mu.device
        eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype,
                          device=gen_device).to(mu.device)
    return mu + eps * torch.exp(0.5 * logvar)
