"""A hyperparameter grid trained as one fold-stacked run (counterpart of
parallel/sweep.py).

The JAX package vmaps its whole-fold trainer twice, over folds and over
configs, with the loss hyperparameters (margins, loss weights: anything
that changes no tensor shape) traced. The port's modules already carry a
fold axis, so S configs x F folds are one model of S * F folds: stacked
fold s * F + f trains config s on fold f. The batches are the F folds'
repeated S times along the fold axis (a few MB at these cohort sizes), each
hyperparameter is an [S * F] tensor the loss reads per fold, and every
stacked fold draws from its own generator seeded alike, as the JAX package
gives every (config, fold) the same key.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..interop import params_to_jax
from ..train.trainer import StateUpdate, TrainConfig
from .folds import MultiFoldTrainer


def stack_hypers(configs: Sequence[dict], folds: int = 1,
                 device=None) -> Dict[str, torch.Tensor]:
    """[{name: scalar}] of S configs -> {name: [S * folds] float32 tensor},
    each config's value repeated over its ``folds`` stacked folds."""
    keys = sorted(configs[0])
    for c in configs:
        if sorted(c) != keys:
            raise ValueError("all sweep configs need the same keys")
    return {k: torch.tensor([float(c[k]) for c in configs
                             for _ in range(folds)], dtype=torch.float32,
                            device=device)
            for k in keys}


def repeat_folds(batches: dict, repeats: int) -> dict:
    """``stack_fold_batches`` output with its F folds repeated ``repeats``
    times along the fold axis, config-major: [repeats * F, NB, B, ...]."""
    def rep(a):
        return np.concatenate([np.asarray(a)] * repeats, axis=0)

    out = {"x": tuple(rep(a) for a in batches["x"]),
           "c": tuple(rep(a) for a in batches["c"]),
           "mask": rep(batches["mask"]), "valid": rep(batches["valid"])}
    if "extras" in batches:
        out["extras"] = {k: rep(v) for k, v in batches["extras"].items()}
    return out


class SweepTrainer:
    """Trains S hyperparameter configs x F folds at once. ``model`` holds
    S * F folds (config-major) and is trained in place from whatever
    weights it holds (the CLIs give every stacked fold the same init, as
    the reference re-seeds 42 per grid point). ``loss_fn(hyper)`` returns
    the trainer's loss for the hyperparameters ``hyper`` ({name: [S * F]
    tensor}, ``stack_hypers``)."""

    def __init__(self, model, config: TrainConfig, n_samples: int,
                 loss_fn: Callable[[dict], Callable],
                 state_update: Optional[StateUpdate] = None):
        self.model = model
        self.config = config
        self.n_samples = n_samples
        self.loss_fn = loss_fn
        self.state_update = state_update

    def run(self, batches: dict, configs: Sequence[dict], **draws
            ) -> Tuple[List[list], List[list]]:
        """``batches``: the F folds' ``stack_fold_batches`` output;
        ``configs``: S hyper dicts; ``draws``: replayed noise for all
        S * F stacked folds (``MultiFoldTrainer.session``). Returns
        (params[S][F] JAX-layout trees, logs[S][F] {key: [epochs]})."""
        n_configs = len(configs)
        stacked = self.model.folds
        if stacked % n_configs:
            raise ValueError(f"the model holds {stacked} folds, not a "
                             f"multiple of the {n_configs} configs")
        n_folds = stacked // n_configs
        device = next(self.model.parameters()).device
        hyper = stack_hypers(configs, n_folds, device)
        trainer = MultiFoldTrainer(self.model, self.config, self.n_samples,
                                   loss_fn=self.loss_fn(hyper),
                                   state_update=self.state_update)
        logs = trainer.run(repeat_folds(batches, n_configs), **draws)
        params = [[params_to_jax(self.model, fold=s * n_folds + f)
                   for f in range(n_folds)] for s in range(n_configs)]
        grid_logs = [[{k: v[s * n_folds + f] for k, v in logs.items()}
                      for f in range(n_folds)] for s in range(n_configs)]
        return params, grid_logs
