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
    ReplayNoise,
    StateUpdate,
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
                       batch_size: int,
                       extras: Optional[Sequence[dict]] = None) -> dict:
    """The [F, NB, B, ...] batches of every fold (numpy). Folds may differ in
    sample count; every fold is padded to the largest fold's batch grid with
    whole all-padding batches (mask 0, valid False). ``extras`` holds one
    {name: per-sample array} per fold (labels, the FI score)."""
    max_n = max(d[0].shape[0] for d in per_fold_data)
    nb = max(1, -(-max_n // batch_size))

    def pad(a):
        widths = [(0, nb - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, widths)

    folds = [make_batches(d, c, batch_size, extras[f] if extras else None)
             for f, (d, c) in enumerate(zip(per_fold_data, per_fold_cov))]
    out = {
        "x": tuple(np.stack([pad(f["x"][m]) for f in folds])
                   for m in range(len(folds[0]["x"]))),
        "c": tuple(np.stack([pad(f["c"][m]) for f in folds])
                   for m in range(len(folds[0]["c"]))),
        "mask": np.stack([pad(f["mask"]) for f in folds]),
        "valid": np.stack([pad(f["valid"]) for f in folds]),
    }
    if extras:
        out["extras"] = {k: np.stack([pad(f["extras"][k]) for f in folds])
                         for k in folds[0]["extras"]}
    return out


class MultiFoldTrainer:
    """Trains every fold of a fold-stacked model at once: the port's only
    plain trainer. The JAX package's per-fold path and its --fold_parallel
    path follow the same trajectory (train/trainer.py:317-323), so both map
    onto this one. With ``config.shuffle`` each fold's rows are permuted
    every epoch over its own batch grid, the JAX package's sequential
    per-fold numerics (its fold-parallel path falls back to them when fold
    grids differ, cli/common.py:888-896). ``state_update(aux, valid)``
    applies non-gradient state after each step (the end-to-end model's
    BatchNorm running statistics, ``EndToEndCVAE.update_state``)."""

    def __init__(self, model, config: TrainConfig, n_samples: int,
                 loss_fn: Optional[Callable] = None,
                 state_update: Optional[StateUpdate] = None):
        if config.precision != "fp32":
            raise NotImplementedError(
                "MultiFoldTrainer trains in fp32; see ROADMAP.md, queue 1 "
                "item 'Trainer'")
        self.model = model
        self.config = config
        self.lr_fn = build_lr_fn(config, n_samples)
        self.loss_fn = resolve_loss(model, config, loss_fn)
        self.state_update = state_update

    def run(self, stacked_batches, eps=None, keeps=None, perms=None) -> dict:
        """Train ``self.model`` in place, for ``config.epochs`` epochs over
        ``stack_fold_batches`` output (or those batches already uploaded as
        ``DeviceBatches``). By default each fold draws its own noise, keep
        masks (a model with ``keep_widths``) and permutations. Tests replay
        given draws instead: ``eps`` [epochs * NB, F, B, Z] (Z is the
        model's ``noise_dim``), ``keeps`` one [epochs * NB, F, B, width]
        per keep width, ``perms`` [epochs, F, NB * B] when shuffling.
        The batches and the replayed noise take the parameters' dtype.
        Returns the logs {key: [F, epochs] numpy} for every key of the
        model's ``log_keys``."""
        params = list(self.model.parameters())
        device, dtype = params[0].device, params[0].dtype
        batches = stacked_batches
        if not isinstance(batches, DeviceBatches):
            batches = DeviceBatches(stacked_batches, device, dtype)
        keep_widths = getattr(self.model, "keep_widths", ())
        if eps is not None:
            noise = ReplayNoise(eps, device, keeps, perms, dtype)
        else:
            noise = FoldNoise(
                batches.folds, (batches.rows, self.model.noise_dim),
                self.config.seed, device, keep_widths,
                1.0 - getattr(self.model, "dropout_rate", 0.0))
        adam = MaskedAdam(params, self.lr_fn)
        log_keys = self.model.log_keys
        logs = run_epochs(self.loss_fn, params, adam, batches,
                          self.config.epochs, log_keys, noise,
                          shuffle=self.config.shuffle,
                          state_update=self.state_update)
        host = logs.cpu().numpy()
        return {k: host[:, i, :].T.copy() for i, k in enumerate(log_keys)}
