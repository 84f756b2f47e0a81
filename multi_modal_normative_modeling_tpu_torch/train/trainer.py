"""Fold-stacked multimodal cVAE training (counterpart of train/trainer.py).

The JAX trainer runs one fold's epochs as a jitted ``lax.scan`` and vmaps it
over folds. The port's modules hold every fold (parameters [F, ...]), so one
step trains all folds at once: the loss is one value per fold, [F], and the
gradient of its sum is each fold's own gradient (folds share no parameter).

Numerics parity with the JAX trainer:
  * Adam is optax.adam (b1 .9, b2 .999, eps 1e-8 outside the sqrt, bias
    corrected), written out on the fold-stacked tensors with a step count
    per fold, because ``torch.optim.Adam`` keeps one count for everything.
  * A ragged final batch carries a row mask; masked means divide by the
    fold's count of real rows (SURVEY.md Q7). Folds of different sizes are
    padded with whole all-padding batches; on such a batch the fold's
    parameters, Adam moments, step count and noise stream all stay where
    they were (train/trainer.py:317-323).
  * Constant LR 1e-4 by default; the cyclic schedule is an opt-in (Q1).
  * The logs are each epoch's first-batch loss terms, before that step's
    update (the reference's print cadence, train:201-209).

Batches, noise and logs stay on the device for the whole run: the batches
are uploaded once, and the logs are fetched once at the end.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .schedules import cyclic_triangular

LOG_KEYS = ("total", "kl", "ll")

LossFn = Callable[[dict, torch.Tensor], Tuple[torch.Tensor, dict]]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    epochs: int = 200
    batch_size: int = 256
    learning_rate: float = 1e-4
    combine: str = "gpoe"
    lr_schedule: str = "constant"  # "constant" (parity) or "cyclic"
    base_lr: float = 1e-4
    max_lr: float = 5e-3
    gamma: float = 0.98
    seed: int = 42


def make_batches(data_list: Sequence[np.ndarray],
                 cov_list: Sequence[np.ndarray], batch_size: int) -> dict:
    """Pack one fold's per-modality sample arrays into padded batches
    (train/trainer.py:62-95), leading axis n_batches:
      x:     tuple of [NB, B, D_m] per modality
      c:     tuple of [NB, B, c_dim] per modality
      mask:  [NB, B], 1.0 for real rows
      valid: [NB], True where the batch holds at least one real row
    """
    n = data_list[0].shape[0]
    nb = max(1, -(-n // batch_size))
    padded = nb * batch_size

    def pack(a: np.ndarray) -> np.ndarray:
        a = np.asarray(a, dtype=np.float32)
        out = np.zeros((padded,) + a.shape[1:], dtype=a.dtype)
        out[:n] = a
        return out.reshape((nb, batch_size) + a.shape[1:])

    mask = np.zeros((padded,), dtype=np.float32)
    mask[:n] = 1.0
    return {
        "x": tuple(pack(d) for d in data_list),
        "c": tuple(pack(c) for c in cov_list),
        "mask": mask.reshape(nb, batch_size),
        "valid": mask.reshape(nb, batch_size).sum(axis=1) > 0,
    }


def default_loss_fn(model, config: TrainConfig) -> LossFn:
    """The ELBO of one batch, per fold: forward (encode, fuse,
    reparameterize with the given eps, decode), then ``model.loss``.

    The JAX default for cvae in fp32 merges each encoder's mu and logvar
    heads into one matmul; the JAX package states that the merged math is
    exact on the CPU, so the port runs the heads as two products."""

    def loss_fn(batch: dict, eps: torch.Tensor):
        fwd = model(batch["x"], batch["c"], config.combine, eps=eps)
        losses = model.loss(batch["x"], fwd, batch["mask"])
        return losses["total"], losses

    return loss_fn


def resolve_loss(model, config: TrainConfig,
                 loss_fn: Optional[LossFn]) -> LossFn:
    """The given loss, or the default loss when none is given
    (train/trainer.py:239-257, without the resume fingerprint: resume is
    not ported)."""
    return loss_fn if loss_fn is not None else default_loss_fn(model, config)


def build_lr_fn(config: TrainConfig, n_samples: int):
    """count [F] -> learning rate [F] (train/trainer.py:260-266)."""
    if config.lr_schedule == "cyclic":
        step_size = 2.0 * float(np.ceil(n_samples / config.batch_size))
        return cyclic_triangular(config.base_lr, config.max_lr, step_size,
                                 config.gamma)
    if config.lr_schedule != "constant":
        raise ValueError(f"unknown lr_schedule {config.lr_schedule!r}")
    return lambda count: torch.full_like(count, config.learning_rate)


class MaskedAdam:
    """optax.adam on fold-stacked parameters with one step count per fold,
    updating only the folds a step marks valid.

    The parameters are moved into one flat buffer (each parameter becomes a
    view of it, so its module sees every update) and the moments live in
    two more: a step is a dozen whole-buffer operations whatever the number
    of parameters. Each parameter [F, ...] runs fold by fold inside the
    buffer; a step spreads its per-fold scalars (valid, bias corrections,
    learning rate) over the elements with one ``torch.take`` each through
    the element's fold index. (A row gather of the four scalars at once,
    ``repeat_interleave`` of an [.., 4] table, took 1.2 ms for 2M
    elements on an H100; a 1-D take takes 0.01 ms.)"""

    def __init__(self, params: Sequence[torch.nn.Parameter], lr_fn,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr_fn = lr_fn
        self.b1, self.b2, self.eps = b1, b2, eps
        folds = self.params[0].shape[0]
        sizes = [p.numel() for p in self.params]
        with torch.no_grad():
            self.flat = torch.cat([p.detach().reshape(-1)
                                   for p in self.params])
        for p, view in zip(self.params, self.flat.split(sizes)):
            p.data = view.view_as(p)
        self.m = torch.zeros_like(self.flat)
        self.v = torch.zeros_like(self.flat)
        self.count = torch.zeros(folds, device=self.flat.device)
        runs = torch.tensor([n // folds for n in sizes for _ in range(folds)],
                            device=self.flat.device)
        self._fold_of = torch.repeat_interleave(
            torch.arange(folds, device=self.flat.device).repeat(len(sizes)),
            runs)

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[torch.Tensor]],
             valid: torch.Tensor) -> None:
        """One update from ``grads`` (None: the parameter took no part in
        the loss, a zero gradient) for the folds where ``valid`` [F] is
        1.0; the other folds keep parameters, moments and count."""
        g = torch.cat([(torch.zeros_like(p) if gr is None else gr).reshape(-1)
                       for p, gr in zip(self.params, grads)])
        b1, b2 = self.b1, self.b2
        lr = self.lr_fn(self.count)
        count = self.count + valid

        def spread(per_fold):
            return torch.take(per_fold, self._fold_of)

        keep = spread(valid) > 0
        m = (1.0 - b1) * g + b1 * self.m
        v = (1.0 - b2) * (g * g) + b2 * self.v
        update = ((m / spread(1.0 - b1 ** count))
                  / (torch.sqrt(v / spread(1.0 - b2 ** count)) + self.eps))
        self.flat.copy_(torch.where(keep, self.flat - spread(lr) * update,
                                    self.flat))
        self.m.copy_(torch.where(keep, m, self.m))
        self.v.copy_(torch.where(keep, v, self.v))
        self.count = count


class FoldNoise:
    """The reparameterization noise of each step, one torch generator per
    fold on the device, all seeded alike (the reference re-seeds 42 per
    fold, so every fold draws the same stream). A fold draws only on a step
    where its batch is valid, so padding batches leave its stream where it
    was. Tests replay the JAX package's draws instead (``eps=``)."""

    def __init__(self, folds: int, shape: Tuple[int, int], seed: int,
                 device):
        self.shape = shape
        self.device = device
        self.gens = [torch.Generator(device=device).manual_seed(seed)
                     for _ in range(folds)]

    def draw(self, valid: np.ndarray) -> torch.Tensor:
        """Noise [F, B, Z] for a step whose per-fold validity is ``valid``
        (host booleans, so drawing needs no device sync)."""
        return torch.stack([
            torch.randn(self.shape, generator=gen, device=self.device) if ok
            else torch.zeros(self.shape, device=self.device)
            for gen, ok in zip(self.gens, valid)])


class DeviceBatches:
    """Stacked batches ([F, NB, B, ...] numpy, as parallel.folds.
    stack_fold_batches builds them) uploaded once, step-major, so each
    step's slice is a contiguous [F, B, ...] tensor."""

    def __init__(self, batches: dict, device):
        def up(a):
            return torch.from_numpy(np.ascontiguousarray(
                np.swapaxes(np.asarray(a, np.float32), 0, 1))).to(device)

        self.x = [up(a) for a in batches["x"]]
        self.c = [up(a) for a in batches["c"]]
        self.mask = up(batches["mask"])
        self.valid_host = np.asarray(batches["valid"]).T  # [NB, F]
        self.valid = torch.from_numpy(
            self.valid_host.astype(np.float32)).to(device)
        self.n_batches, self.folds, self.rows = self.mask.shape

    def step(self, t: int) -> dict:
        return {"x": [x[t] for x in self.x], "c": [c[t] for c in self.c],
                "mask": self.mask[t]}


def run_epochs(loss_fn: LossFn, params: List[torch.nn.Parameter],
               adam: MaskedAdam, batches: DeviceBatches, epochs: int,
               eps: Optional[torch.Tensor] = None,
               noise: Optional[FoldNoise] = None) -> torch.Tensor:
    """The epoch loop: every batch of every epoch is one step for all folds.
    ``eps`` [epochs * NB, F, B, Z] replays given noise; otherwise ``noise``
    draws it. Returns the logs [epochs, 3, F] (LOG_KEYS) on the device."""
    logs = torch.empty((epochs, len(LOG_KEYS), batches.folds),
                       device=batches.mask.device)
    t = 0
    for epoch in range(epochs):
        for step in range(batches.n_batches):
            noise_t = (eps[t] if eps is not None
                       else noise.draw(batches.valid_host[step]))
            total, aux = loss_fn(batches.step(step), noise_t)
            grads = torch.autograd.grad(total.sum(), params,
                                        allow_unused=True)
            if step == 0:
                logs[epoch] = torch.stack([aux[k].detach()
                                           for k in LOG_KEYS])
            adam.step(grads, batches.valid[step])
            t += 1
    return logs
