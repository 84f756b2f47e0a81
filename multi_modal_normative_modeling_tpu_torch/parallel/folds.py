"""Fold stacking and fold-parallel training (counterpart of
parallel/folds.py).

The JAX package vmaps one fold's program over fold-stacked params
(cli/common.py:643-661, parallel/folds.py:135). The port writes that batch
dimension out: every parameter of a model carries a leading fold axis, the
kernels take the fold as a grid axis, and ``MultiFoldTrainer`` trains every
fold in each step. ``stack_params`` builds a fold-stacked tree from per-fold
trees, e.g. the ones ``interop.read_flax_checkpoint`` returns.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..train.trainer import (
    DeviceBatches,
    FoldNoise,
    MaskedAdam,
    TrainConfig,
    build_lr_fn,
    make_batches,
    resolve_loss,
    run_epochs,
)


def stack_params(params_list: Sequence):
    """Stack per-fold parameter trees (nested dicts and lists whose leaves
    are numpy arrays or tensors) along a new leading fold axis."""
    if not params_list:
        raise ValueError("stack_params: no parameter trees to stack")
    first = params_list[0]
    if isinstance(first, dict):
        return {k: stack_params([p[k] for p in params_list]) for k in first}
    if isinstance(first, (list, tuple)):
        if any(len(p) != len(first) for p in params_list):
            raise ValueError("stack_params: trees differ in list lengths")
        return [stack_params([p[i] for p in params_list])
                for i in range(len(first))]
    if isinstance(first, torch.Tensor):
        return torch.stack(list(params_list))
    return np.stack(params_list)


def unstack_params(stacked, n_folds: int) -> List:
    """Slice the leading fold axis of a stacked tree: one tree per fold."""
    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [take(v, i) for v in node]
        return node[i]

    return [take(stacked, i) for i in range(n_folds)]


def stack_fold_batches(per_fold_data: Sequence[Sequence[np.ndarray]],
                       per_fold_cov: Sequence[Sequence[np.ndarray]],
                       batch_size: int) -> dict:
    """The [F, NB, B, ...] batches of every fold (numpy). Folds may differ in
    sample count; every fold is padded to the largest fold's batch grid with
    whole all-padding batches (mask 0, valid False)."""
    max_n = max(d[0].shape[0] for d in per_fold_data)
    nb = max(1, -(-max_n // batch_size))

    def pad(a):
        widths = [(0, nb - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, widths)

    folds = [make_batches(d, c, batch_size)
             for d, c in zip(per_fold_data, per_fold_cov)]
    return {
        "x": tuple(np.stack([pad(f["x"][m]) for f in folds])
                   for m in range(len(folds[0]["x"]))),
        "c": tuple(np.stack([pad(f["c"][m]) for f in folds])
                   for m in range(len(folds[0]["c"]))),
        "mask": np.stack([pad(f["mask"]) for f in folds]),
        "valid": np.stack([pad(f["valid"]) for f in folds]),
    }


class MultiFoldTrainer:
    """Trains every fold of a fold-stacked model at once: the port's only
    trainer. The JAX package's per-fold path and its --fold_parallel path
    follow the same trajectory (train/trainer.py:317-323), so both map onto
    this one."""

    def __init__(self, model, config: TrainConfig, n_samples: int,
                 loss_fn: Optional[Callable] = None):
        if config.precision != "fp32" or config.shuffle:
            raise NotImplementedError(
                "MultiFoldTrainer trains in fp32 without shuffle; see "
                "ROADMAP.md, queue 1 item 'Trainer'")
        self.model = model
        self.config = config
        self.lr_fn = build_lr_fn(config, n_samples)
        self.loss_fn = resolve_loss(model, config, loss_fn)

    def run(self, stacked_batches, eps=None) -> dict:
        """Train ``self.model`` in place, for ``config.epochs`` epochs over
        ``stack_fold_batches`` output (or those batches already uploaded as
        ``DeviceBatches``). ``eps`` [epochs * NB, F, B, Z] replays given
        noise (tests; Z is the model's ``noise_dim``); by default each fold
        draws its own. Returns the logs {key: [F, epochs] numpy} for every
        key of the model's ``log_keys``."""
        params = list(self.model.parameters())
        device = params[0].device
        batches = stacked_batches
        if not isinstance(batches, DeviceBatches):
            batches = DeviceBatches(stacked_batches, device)
        noise = None
        if eps is not None:
            eps = torch.as_tensor(eps, dtype=torch.float32).to(device)
        else:
            noise = FoldNoise(batches.folds,
                              (batches.rows, self.model.noise_dim),
                              self.config.seed, device)
        adam = MaskedAdam(params, self.lr_fn)
        log_keys = self.model.log_keys
        logs = run_epochs(self.loss_fn, params, adam, batches,
                          self.config.epochs, log_keys, eps=eps, noise=noise)
        host = logs.cpu().numpy()
        return {k: host[:, i, :].T.copy() for i, k in enumerate(log_keys)}
