"""Standalone MLP diagnosis baseline (counterpart of models/classifier.py,
the reference's classifier_baseline/classifier.py).

The JAX package runs the reference's full-batch training loop (classifier.py:
247-329) as one jitted scan over epochs and vmaps it over a grid of
hyperparameters. Here one module holds S configurations: every layer is a
fold-stacked linear (``ops/linear.FoldLinear``, weights [S, out, in]) and
the input [N, D] is shared by all. ``train_classifier`` is S = 1 and
``sweep_classifiers`` S = n, on one code path (``_train``); on a mesh of
ranks with a 'config' axis each rank trains its block of the grid and the
blocks are gathered on every rank. The epoch loop
keeps its whole carry on the device: the scheduler's own best, the plateau
count, the learning rate, the best validation loss and parameters, the
early-stop count and the ``stopped`` flag, one per configuration. No epoch
reads a value back: 1000 epochs make no host sync, and the history is
fetched once at the end.

  * Adam is ``train/trainer.MaskedAdam`` (held to optax.adam); a
    configuration that has stopped early is not ``valid``, so its
    parameters, moments and step count stay as they were, as the JAX
    package's ``jnp.where(stopped, ...)`` keeps them. Its learning rate is
    the carry's.
  * ReduceLROnPlateau (mode min, relative threshold 1e-4, torch's
    defaults): the scheduler keeps its own best, updated only when the
    threshold test passes; the rate is cut by ``factor`` when the plateau
    count exceeds ``patience`` and clamped at ``min_lr``.
  * Best-validation checkpoint on a strict improvement
    (classifier.py:303-310), early stop after ``early_stopping_patience``
    epochs without one.
  * Dropout keeps an element where a uniform draw is below 1 - rate (as
    ``jax.random.bernoulli``) and scales it by 1 / (1 - rate). The draws
    come from one ``torch.Generator`` seeded ``seed`` on the device; every
    configuration of a grid thresholds the same draws by its own rate, so a
    grid point trains as its standalone run does (every JAX grid point is
    seeded alike). ``mask_fn`` replaces the draws (tests replay JAX's
    Bernoulli masks through it).
"""
from __future__ import annotations

import copy
import warnings
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..evaluation import metrics
from ..ops.linear import init_mlp
from ..ops.losses import cross_entropy_logits
from ..train.trainer import MaskedAdam

# (epoch, hidden layer, [N, width], keep probabilities [S]) -> keep masks
# [S, N, width]
MaskFn = Callable[[int, int, Tuple[int, int], torch.Tensor], torch.Tensor]
HISTORY_KEYS = ("train_loss", "val_loss", "lr")


def _linear(layer, h: torch.Tensor) -> torch.Tensor:
    """``h @ weight^T + bias`` of a config-stacked layer with autograd's own
    sum of the bias gradient over the rows: not ``ops/linear.apply_linear``'s
    fold-count-independent sum. Chip_smoke phase 14a holds each grid point
    to its one-configuration run, and a sum in another order let Adam
    carry one grid point's last-bit difference to 3.8e-04 on an H100."""
    return h @ layer.weight.mT + layer.bias.unsqueeze(-2)


class MLPClassifier(nn.Module):
    """Linear -> ReLU -> Dropout blocks and a final Linear to the classes
    (classifier.py:25-53), for ``configs`` configurations at once."""

    def __init__(self, input_size: int, hidden_layers: Sequence[int],
                 dropout: float = 0.2, num_classes: int = 2,
                 configs: int = 1,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.sizes = [input_size] + list(hidden_layers) + [num_classes]
        self.dropout = dropout
        self.configs = configs
        self.layers = init_mlp(self.sizes, configs, generator, device)
        self.to(dtype)

    def forward(self, x: torch.Tensor, rate: Optional[torch.Tensor] = None,
                keep: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        """Logits [S, N, classes] of x [N, D] (or [S, N, D]). In training
        ``keep`` holds one [S, N, width] mask per hidden layer and ``rate``
        the dropout rate per configuration [S]; without them no dropout."""
        h = x
        for i, layer in enumerate(self.layers[:-1]):
            h = torch.relu(_linear(layer, h))
            if keep is not None:
                h = torch.where(keep[i], h / (1.0 - rate)[:, None, None],
                                h.new_zeros(()))
        return _linear(self.layers[-1], h)

    def stacked(self, configs: int) -> "MLPClassifier":
        """A copy holding ``configs`` configurations, each starting from
        this (one-configuration) model's parameters."""
        if self.configs != 1:
            raise ValueError(f"stacked: the model holds {self.configs} "
                             "configurations, expected 1")
        out = copy.deepcopy(self)
        out.configs = configs
        with torch.no_grad():
            for p in out.parameters():
                p.data = p.data.expand((configs,) + p.shape[1:]).clone()
        return out


class LogisticRegressionModel(MLPClassifier):
    """Single-linear-layer binary classifier (classifier_baseline/
    classifier.py:218-245): the MLP with no hidden block. The reference
    never instantiates it; it is part of the module's surface."""

    def __init__(self, input_size: int, num_classes: int = 2,
                 configs: int = 1,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__(input_size, [], dropout=0.0,
                         num_classes=num_classes, configs=configs,
                         generator=generator, device=device, dtype=dtype)


def _draw_masks(generator: torch.Generator, mask_fn: Optional[MaskFn],
                epoch: int, widths: Sequence[int], rows: int,
                keep_prob: torch.Tensor):
    """One [S, N, width] keep mask per hidden layer."""
    masks = []
    for i, width in enumerate(widths):
        if mask_fn is not None:
            masks.append(mask_fn(epoch, i, (rows, width), keep_prob)
                         .to(device=keep_prob.device, dtype=torch.bool))
            continue
        u = torch.rand((rows, width), generator=generator,
                       device=keep_prob.device, dtype=keep_prob.dtype)
        masks.append(u[None] < keep_prob[:, None, None])
    return masks


def run_epochs(step: Callable[[int], None], num_epochs: int) -> None:
    """The epoch loop: ``step(epoch)`` queues one epoch's work on the
    device and reads nothing back (chip_smoke.py runs this loop under
    ``torch.cuda.set_sync_debug_mode("error")``)."""
    for epoch in range(num_epochs):
        step(epoch)


def _train(model: MLPClassifier, x_train, y_train, x_val, y_val,
           num_epochs: int, hyper: dict, early_stopping_patience: int,
           seed: int, mask_fn: Optional[MaskFn]):
    """Train every configuration of ``model`` in place (its parameters end
    as the last epoch's). ``hyper`` holds initial_lr, factor, patience,
    min_lr and dropout, one per configuration. Returns (the best-validation
    parameters as a copy of the model, history {key: [epochs, S] on the
    host})."""
    device = next(model.parameters()).device
    dtype = next(model.parameters()).dtype
    s = model.configs

    def per_config(name, kind=dtype):
        return torch.as_tensor(np.asarray(hyper[name], np.float64)
                               .reshape(s), dtype=kind, device=device)

    def as_device(a, kind):
        return torch.as_tensor(np.asarray(a), device=device).to(kind)

    classes = model.sizes[-1]
    for name, labels in (("y_train", y_train), ("y_val", y_val)):
        found = np.unique(np.asarray(labels))
        if found.size and (found.min() < 0 or found.max() >= classes):
            raise ValueError(f"{name}: labels {found.tolist()} outside the "
                             f"model's {classes} classes")
    x_train, x_val = as_device(x_train, dtype), as_device(x_val, dtype)
    y_train = as_device(y_train, torch.int64).expand(s, -1)
    y_val = as_device(y_val, torch.int64).expand(s, -1)
    lr, factor = per_config("initial_lr"), per_config("factor")
    min_lr, rate = per_config("min_lr"), per_config("dropout")
    patience = per_config("patience", torch.int64)
    keep_prob = 1.0 - rate
    dropout = bool(np.any(np.asarray(hyper["dropout"]) > 0.0))
    generator = torch.Generator(device=device).manual_seed(seed)
    widths = model.sizes[1:-1]

    params = list(model.parameters())
    adam = MaskedAdam(params, lambda count: carry["lr"])
    # each element's configuration, uploaded here: the epoch loop syncs
    # with the host nowhere
    config_of = adam._fold_of
    inf = torch.full((s,), float("inf"), dtype=dtype, device=device)
    zero = torch.zeros(s, dtype=torch.int64, device=device)
    carry = {"lr": lr, "best_flat": adam.flat.clone(),
             "best_val": inf.clone(), "sched_best": inf.clone(),
             "plateau": zero.clone(), "since_best": zero.clone(),
             "stopped": torch.zeros(s, dtype=torch.bool, device=device)}
    history = {k: torch.empty((num_epochs, s), dtype=dtype, device=device)
               for k in HISTORY_KEYS}

    def step(epoch: int) -> None:
        keep = (_draw_masks(generator, mask_fn, epoch, widths,
                            x_train.shape[0], keep_prob)
                if dropout else None)
        train_loss = cross_entropy_logits(model(x_train, rate, keep),
                                          y_train)
        grads = torch.autograd.grad(train_loss.sum(), params)
        stopped = carry["stopped"]
        adam.step(grads, (~stopped).to(dtype))
        with torch.no_grad():
            val_loss = cross_entropy_logits(model(x_val), y_val)
            # ReduceLROnPlateau: the scheduler's own best
            improved = val_loss < carry["sched_best"] * (1.0 - 1e-4)
            carry["sched_best"] = torch.where(improved, val_loss,
                                              carry["sched_best"])
            plateau = torch.where(improved, zero, carry["plateau"] + 1)
            reduce = plateau > patience
            lr = carry["lr"]
            new_lr = torch.where(reduce, torch.maximum(lr * factor, min_lr),
                                 lr)
            carry["plateau"] = torch.where(reduce, zero, plateau)
            carry["lr"] = torch.where(stopped, lr, new_lr)
            # best-validation checkpoint, then early stopping
            better = (val_loss < carry["best_val"]) & ~stopped
            carry["best_flat"] = torch.where(
                torch.take(better, config_of), adam.flat,
                carry["best_flat"])
            carry["since_best"] = torch.where(better, zero,
                                              carry["since_best"] + 1)
            carry["best_val"] = torch.minimum(carry["best_val"], val_loss)
            carry["stopped"] = stopped | (carry["since_best"]
                                          >= early_stopping_patience)
            history["train_loss"][epoch] = train_loss.detach()
            history["val_loss"][epoch] = val_loss
            history["lr"][epoch] = carry["lr"]

    run_epochs(step, num_epochs)
    best = copy.deepcopy(model)
    with torch.no_grad():
        for p, view in zip(best.parameters(), carry["best_flat"].split(
                [p.numel() for p in params])):
            p.data = view.view_as(p).clone()
    return best, {k: v.cpu().numpy() for k, v in history.items()}


def train_classifier(model: MLPClassifier, x_train, y_train, x_val, y_val,
                     num_epochs: int, initial_lr: float, factor: float,
                     patience: int, min_lr: float,
                     early_stopping_patience: int = 10000, seed: int = 42,
                     mask_fn: Optional[MaskFn] = None
                     ) -> Tuple[MLPClassifier, dict]:
    """Full-batch Adam + ReduceLROnPlateau + best-validation checkpoint +
    early stop, for a one-configuration ``model``, which it trains in place.
    Returns (a copy holding the best-validation parameters, history): the
    per-epoch train loss, validation loss and learning rate, each
    [num_epochs]."""
    if model.configs != 1:
        raise ValueError(f"train_classifier: the model holds "
                         f"{model.configs} configurations; use "
                         "sweep_classifiers")
    hyper = {"initial_lr": initial_lr, "factor": factor,
             "patience": patience, "min_lr": min_lr,
             "dropout": model.dropout}
    best, history = _train(model, x_train, y_train, x_val, y_val,
                           num_epochs, hyper, early_stopping_patience, seed,
                           mask_fn)
    return best, {k: v[:, 0] for k, v in history.items()}


def sweep_classifiers(model: MLPClassifier, x_train, y_train, x_val, y_val,
                      num_epochs: int, configs, seed: int = 42, mesh=None,
                      mask_fn: Optional[MaskFn] = None):
    """Train the (lr, factor, patience, min_lr, dropout) grid of
    ``configs`` (classifier_baseline/tune_parameter.sh, minus the axes that
    change shapes) as one model of len(configs) configurations, each from
    the one-configuration ``model``'s parameters. Returns (the best
    parameters, one model of S configurations; a history dict per
    configuration).

    With ``mesh`` (any mesh of ranks with a 'config' axis, e.g.
    parallel.mesh.make_sweep_mesh) each rank trains its block of the
    configurations; the points are independent and every rank thresholds
    the same dropout draws, so the only collective is the gather of the
    best parameters and histories, which every rank returns whole."""
    n = len(configs)
    mine = range(n)
    if mesh is not None:
        if n % mesh.axis("config"):
            raise ValueError(
                f"classifier sweep mesh: {n} grid configs not divisible by "
                f"the 'config' mesh axis ({mesh.axis('config')})")
        per = n // mesh.axis("config")
        lo = mesh.index("config") * per
        mine = range(lo, lo + per)
    grid = model.stacked(len(mine))
    hyper = {
        "initial_lr": [configs[i]["initial_lr"] for i in mine],
        "factor": [configs[i]["factor"] for i in mine],
        "patience": [configs[i].get("patience", 10) for i in mine],
        "min_lr": [configs[i]["min_lr"] for i in mine],
        "dropout": [configs[i].get("dropout", model.dropout) for i in mine],
    }
    best, history = _train(grid, x_train, y_train, x_val, y_val, num_epochs,
                           hyper, 10000, seed, mask_fn)
    if mesh is not None:
        best, history = _gather_grid(mesh, model, best, history, n)
    return best, [{k: v[:, i] for k, v in history.items()}
                  for i in range(n)]


def _gather_grid(mesh, model: MLPClassifier, best: MLPClassifier,
                 history: dict, n: int):
    """Every rank's block of a classifier grid (the best parameters, the
    histories [epochs, S_local]) put together in config order, from the
    ranks whose other mesh coordinates are 0."""
    others = [a for a in mesh.axis_names if a != "config"]
    mine = (mesh.index("config"),
            all(mesh.index(a) == 0 for a in others),
            {k: p.detach().cpu().numpy()
             for k, p in best.named_parameters()}, history)
    blocks = sorted((c, params, hist) for c, first, params, hist in
                    mesh.all_gather_object(mine) if first)
    whole = model.stacked(n)
    with torch.no_grad():
        for k, p in whole.named_parameters():
            p.data = torch.from_numpy(np.concatenate(
                [params[k] for _, params, _ in blocks])).to(p.device,
                                                           p.dtype)
    return whole, {k: np.concatenate([hist[k] for _, _, hist in blocks],
                                     axis=1) for k in history}


@torch.no_grad()
def evaluate_classifier(model: MLPClassifier, x_test, y_test,
                        config: int = 0) -> dict:
    """Argmax and softmax-probability AUROC metrics of one configuration
    (classifier.py:332-387), by the port's own sklearn-equal metrics: the
    confusion matrix over labels [0, 1], recall and F1 zero where
    undefined, AUROC NaN on a one-class ``y_test``."""
    param = next(model.parameters())
    x = torch.as_tensor(np.asarray(x_test, np.float32),
                        device=param.device).to(param.dtype)
    logits = model(x)[config]
    probs = torch.softmax(logits, dim=1)[:, 1].cpu().numpy()
    y_pred = torch.argmax(logits, dim=1).cpu().numpy()
    y_true = np.asarray(y_test)
    (tn, fp), (fn, tp) = metrics.confusion_matrix(y_true, y_pred,
                                                  labels=[0, 1])
    try:
        auroc = metrics.roc_auc_score(y_true, probs)
    except ValueError:
        auroc = float("nan")
    with warnings.catch_warnings():
        # zero_division=0: an undefined ratio is 0.0, silently
        warnings.simplefilter("ignore", RuntimeWarning)
        recall = metrics.recall_score(y_true, y_pred)
        f1 = metrics.f1_score(y_true, y_pred)
    return {
        "Accuracy": metrics.accuracy_score(y_true, y_pred),
        "Sensitivity (Recall for class 1)": recall,
        "Specificity (Recall for class 0)": tn / (tn + fp) if (tn + fp)
        else 0,
        "F1-Score": f1,
        "AUROC": auroc,
    }
