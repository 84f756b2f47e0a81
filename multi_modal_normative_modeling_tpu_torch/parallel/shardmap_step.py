"""The explicit-collective data-parallel step (counterpart of
parallel/shardmap_step.py).

The default 'data' axis (``MultiFoldTrainer`` on a mesh) reproduces the
unmeshed run: every rank draws the whole batch's noise and keeps its rows,
and the masked means divide by the global row count. This step keeps the
JAX package's ``shard_map`` semantics instead, which differ on purpose:

  * the parameters and the Adam state are replicated on every rank;
  * each rank takes the mean loss over its own rows, and the losses and
    gradients are averaged over 'data' (``pmean``: a sum, then / D);
  * the noise is drawn per rank: with one shard from the generator seeded
    ``seed``, with D > 1 from one seeded by (``seed``, the rank's data
    index), JAX's ``fold_in(key, axis_index)``. A replicated draw would give
    every shard the same rows of noise. The sharded step is then the same
    estimator as the unsharded one, not the same sample; with one shard it
    is the unsharded step.

Tests replay JAX's ``fold_in`` draws through ``eps``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..train.trainer import MaskedAdam
from .mesh import Mesh, row_range


def shard_seed(seed: int, index: int, n_data: int) -> int:
    """The noise seed of data shard ``index``: ``seed`` itself with one
    shard, else one decorrelated per shard."""
    if n_data <= 1:
        return seed
    return int(np.random.SeedSequence([seed, index]).generate_state(1)[0])


class DataParallelStep:
    """``step(xes, cs, eps=None) -> loss [F]`` of a fold-stacked ``model``
    over ``mesh``'s 'data' axis: ``xes`` and ``cs`` are the whole batch
    (per modality [F, B, .], the same on every rank), of which the rank
    takes its rows; ``eps`` [F, B/D, Z] replays the rank's draw."""

    def __init__(self, model, learning_rate, combine: str, mesh: Mesh,
                 seed: int = 0):
        self.model = model
        self.combine = combine
        self.mesh = mesh
        self.n_data = mesh.axis("data")
        params = list(model.parameters())
        self.params = params
        lr_fn = (learning_rate if callable(learning_rate)
                 else (lambda count: torch.full_like(count, learning_rate)))
        self.adam = MaskedAdam(params, lr_fn)
        device = params[0].device
        self.generator = torch.Generator(device=device).manual_seed(
            shard_seed(seed, mesh.index("data"), self.n_data))

    def step(self, xes: Sequence[torch.Tensor], cs: Sequence[torch.Tensor],
             eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        device = self.params[0].device
        r0, r1 = row_range(self.mesh, xes[0].shape[-2])
        xes = [torch.as_tensor(x, device=device)[..., r0:r1, :].contiguous()
               for x in xes]
        cs = [torch.as_tensor(c, device=device)[..., r0:r1, :].contiguous()
              for c in cs]
        if eps is None:
            eps = torch.randn(
                (xes[0].shape[0], r1 - r0, self.model.noise_dim),
                generator=self.generator, device=device)
        fwd = self.model(xes, cs, self.combine, eps=torch.as_tensor(
            eps, device=device))
        loss = self.model.loss(xes, fwd)["total"]
        grads = torch.autograd.grad(loss.sum(), self.params,
                                    allow_unused=True)
        flat = self.adam.flatten(grads)
        loss = loss.detach().clone()
        if self.n_data > 1:
            self.mesh.all_reduce_(flat, "data").div_(self.n_data)
            self.mesh.all_reduce_(loss, "data").div_(self.n_data)
        self.adam.step_flat(flat, torch.ones_like(self.adam.count))
        return loss


def build_dp_step_shardmap(model, learning_rate, combine: str, mesh: Mesh,
                           seed: int = 0) -> DataParallelStep:
    """The step over ``mesh``'s 'data' axis (parallel/shardmap_step.py:18);
    ``learning_rate`` is a float or a count [F] -> lr [F] function."""
    return DataParallelStep(model, learning_rate, combine, mesh, seed)
