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

from ..interop import params_to_jax
from ..train.checkpoints import run_chunked
from ..train.trainer import (
    DeviceBatches,
    FoldNoise,
    MaskedAdam,
    ReplayNoise,
    StateUpdate,
    TrainConfig,
    TrainSession,
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
    BatchNorm running statistics, ``EndToEndCVAE.update_state``).

    ``run``, ``run_milestones`` and ``run_resumable`` advance one
    ``TrainSession``: a run in chunks (milestones, checkpoints) is the
    uninterrupted run, bit for bit. An eager loop compiles nothing, so the
    JAX package's compile-reuse policy for chunk sizes has no counterpart.
    """

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
        self.loss_fn, self.loss_meta = resolve_loss(model, config, loss_fn)
        self.state_update = state_update
        self.resumed_from = 0   # the epoch run_resumable took the run up at

    def session(self, stacked_batches, eps=None, keeps=None,
                perms=None, seeds=None) -> TrainSession:
        """A new run of ``self.model`` (trained in place) over
        ``stack_fold_batches`` output (or those batches already uploaded as
        ``DeviceBatches``). By default each fold draws its own noise, keep
        masks (a model with ``keep_widths``) and permutations from a
        generator seeded ``config.seed``, or ``seeds[f]`` for fold f when
        ``seeds`` is given (``FoldNoise``). Tests replay given draws
        instead: ``eps`` [epochs * NB, F, B, Z] (Z is the model's
        ``noise_dim``), ``keeps`` one [epochs * NB, F, B, width] per keep
        width, ``perms`` [epochs, F, NB * B] when shuffling.
        The batches and the replayed noise take the parameters' dtype."""
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
                1.0 - getattr(self.model, "dropout_rate", 0.0), seeds)
        adam = MaskedAdam(params, self.lr_fn)
        log_keys = self.model.log_keys

        def chunk(first_epoch, epochs):
            return run_epochs(self.loss_fn, params, adam, batches, epochs,
                              log_keys, noise, shuffle=self.config.shuffle,
                              state_update=self.state_update,
                              first_epoch=first_epoch)

        return TrainSession(chunk, adam, noise, log_keys,
                            dict(self.model.named_buffers()))

    def run(self, stacked_batches, **draws) -> dict:
        """Train ``self.model`` in place for ``config.epochs`` epochs (the
        arguments are ``session``'s). Returns the logs {key: [F, epochs]
        numpy} for every key of the model's ``log_keys``."""
        session = self.session(stacked_batches, **draws)
        session.advance(self.config.epochs)
        return session.logs()

    def run_milestones(self, stacked_batches, milestones: Sequence[int],
                       **draws):
        """Train to each milestone epoch (ascending) in turn, yielding
        ``(epoch, per-fold params in the JAX layout, logs)`` after each
        (parallel/folds.py:245-269): one run to max(milestones) serves every
        epoch count of a grid, each snapshot equal to the run of that many
        epochs. The model trains in place; a snapshot is a copy."""
        session = self.session(stacked_batches, **draws)
        folds = session.adam.count.shape[0]
        for m in milestones:
            if m < session.epoch:
                raise ValueError(f"milestones must ascend, got {milestones}")
            session.advance(m - session.epoch)
            yield (m, [params_to_jax(self.model, fold=f)
                       for f in range(folds)], session.logs())

    def run_resumable(self, stacked_batches, state_dir,
                      checkpoint_every: int, resume: bool = True,
                      **draws) -> dict:
        """``run`` in chunks of ``checkpoint_every`` epochs, one whole-run
        train state under ``state_dir`` saved after each
        (parallel/folds.py:271-310); with ``resume`` a stored state is
        continued. Per-fold ``seeds`` join the run's fingerprint, so a
        resume over another replicate set is refused. Returns the whole
        run's logs; ``resumed_from`` is the epoch this call took the run up
        at."""
        session = self.session(stacked_batches, **draws)
        meta = dict(self.loss_meta)
        if draws.get("seeds") is not None:
            meta["fold_seeds"] = ",".join(str(int(s)) for s in draws["seeds"])
        run_chunked(state_dir, self.config.epochs, checkpoint_every, resume,
                    session, meta)
        self.resumed_from = session.start_epoch
        return session.logs()
