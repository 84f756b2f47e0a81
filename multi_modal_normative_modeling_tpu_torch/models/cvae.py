"""Conditional encoder/decoder modules (counterpart of models/cvae.py).

  Encoder: concat(x, c) -> hidden linears (+LeakyReLU when non_linear) ->
           parallel mu / logvar heads.
  Decoder: concat(z, c) -> reversed hidden linears (+LeakyReLU) -> mean head,
           plus a learnable homoscedastic output logvar initialized to -3
           (cVAE.py:193-194).
  Classifier: the end-to-end model's latent classifier head
           (cVAE.py:2004-2018): per block Linear -> BatchNorm1d -> ReLU ->
           Dropout, then a Linear to the classes.

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
from ..ops.losses import row_count, row_sum


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
        # parallel.tensor.TensorParallel while the weights are split over
        # a 'model' mesh axis
        self.tp = None

    def hidden_layers(self) -> List[Layer]:
        return [layer.pair() for layer in self.hidden]

    def forward(self, x: torch.Tensor, c: torch.Tensor):
        """(mu, logvar), each [F, B, Z]."""
        if self.tp is not None:
            return self.tp.encoder(self, x, c)
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
        self.tp = None   # as Encoder.tp

    def hidden_layers(self) -> List[Layer]:
        return [layer.pair() for layer in self.hidden]

    def forward(self, z: torch.Tensor, c: torch.Tensor):
        """(mean [F, B, D], logvar_out [F, 1, D]) of the reconstruction
        Normal."""
        if self.tp is not None:
            return self.tp.decoder(self, z, c)
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


class ClassifierBlock(nn.Module):
    """One Linear -> BatchNorm block's parameters: the linear and the
    BatchNorm affine scale and shift, each [F, width]."""

    def __init__(self, fan_in: int, width: int, folds: int = 1,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.linear = FoldLinear(fan_in, width, folds, generator, device)
        self.bn_scale = nn.Parameter(torch.ones((folds, width), device=device))
        self.bn_bias = nn.Parameter(torch.zeros((folds, width), device=device))


class RunningStats(nn.Module):
    """A BatchNorm block's running mean and variance, buffers [F, width]."""

    def __init__(self, width: int, folds: int = 1, device=None):
        super().__init__()
        self.register_buffer("mean", torch.zeros((folds, width),
                                                 device=device))
        self.register_buffer("var", torch.ones((folds, width), device=device))


class Classifier(nn.Module):
    """The latent classifier head (models/cvae.py:104-166 of the JAX
    package) with a leading fold axis.

    BatchNorm follows torch's BatchNorm1d (momentum 0.1, eps 1e-5): in
    train mode a block normalizes by the batch statistics over the valid
    rows of each fold, and ``forward`` returns the running statistics the
    step would leave, the unbiased variance var * n / max(n - 1, 1) tracked,
    without touching the buffers (``state``): the trainer writes them back
    for the folds whose step is valid (``update_state``). In eval mode a
    block normalizes by the running statistics and dropout is off.

    Dropout keeps an element with probability 1 - ``dropout_rate`` and
    scales it by 1 / (1 - rate). Its keep masks, one [F, B, width] per
    block, are given (``keep``: the trainer's draws, or the JAX package's
    replayed in tests) or drawn from ``generator``."""

    def __init__(self, latent_dim: int, layers: Sequence[int],
                 num_classes: int = 2, dropout_rate: float = 0.5,
                 folds: int = 1, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        sizes = [latent_dim] + list(layers)
        self.widths = tuple(layers)
        self.dropout_rate = dropout_rate
        self.blocks = nn.ModuleList(
            ClassifierBlock(sizes[i], sizes[i + 1], folds, generator, device)
            for i in range(len(sizes) - 1))
        self.out = FoldLinear(sizes[-1], num_classes, folds, generator,
                              device)
        self.state = nn.ModuleList(RunningStats(w, folds, device)
                                   for w in self.widths)

    def forward(self, z: torch.Tensor, train: bool,
                mask: Optional[torch.Tensor] = None,
                keep: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
        """(logits [F, B, classes], the running statistics after this batch:
        one (mean, var) pair of [F, width] per block, detached)."""
        h = z
        new_state = []
        for i, block in enumerate(self.blocks):
            h = block.linear(h)
            stats = self.state[i]
            if train:
                if mask is None:
                    mean = torch.mean(h, dim=-2)
                    var = torch.var(h, dim=-2, unbiased=False)
                    n = h.new_tensor(float(h.shape[-2]))
                else:
                    # the whole batch's rows on a data-sharded rank
                    # (ops.losses.global_row_counts)
                    m = mask.to(h.dtype).unsqueeze(-1)
                    n = torch.clamp(row_count(mask.to(h.dtype)),
                                    min=1.0).unsqueeze(-1)
                    mean = row_sum(h * m) / n
                    var = row_sum((h - mean.unsqueeze(-2)) ** 2 * m) / n
                unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                new_state.append(((0.9 * stats.mean + 0.1 * mean).detach(),
                                  (0.9 * stats.var + 0.1 * unbiased).detach()))
            else:
                mean, var = stats.mean, stats.var
                new_state.append((mean, var))
            h = ((h - mean.unsqueeze(-2))
                 / torch.sqrt(var.unsqueeze(-2) + 1e-5))
            h = h * block.bn_scale.unsqueeze(-2) + block.bn_bias.unsqueeze(-2)
            h = torch.relu(h)
            if train and self.dropout_rate > 0.0:
                keep_i = (keep[i] if keep is not None
                          else draw_keep(h.shape, 1.0 - self.dropout_rate,
                                         generator, h.device))
                h = torch.where(keep_i.to(torch.bool),
                                h / (1.0 - self.dropout_rate),
                                h.new_zeros(()))
        return self.out(h), new_state

    @torch.no_grad()
    def update_state(self, new_state, valid: torch.Tensor) -> None:
        """Write ``forward``'s running statistics into the buffers of the
        folds where ``valid`` [F] is 1.0."""
        keep = valid.to(torch.bool).unsqueeze(-1)
        for stats, (mean, var) in zip(self.state, new_state):
            stats.mean.copy_(torch.where(keep, mean, stats.mean))
            stats.var.copy_(torch.where(keep, var, stats.var))


def draw_keep(shape, keep_prob: float,
              generator: Optional[torch.Generator] = None,
              device=None) -> torch.Tensor:
    """A dropout keep mask: True with probability ``keep_prob`` (drawn on
    the generator's device, then moved)."""
    gen_device = generator.device if generator is not None else device
    u = torch.rand(shape, generator=generator, device=gen_device)
    return (u < keep_prob).to(device)
