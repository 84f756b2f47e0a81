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
    parameters, Adam moments, step count, non-gradient state (BatchNorm
    running statistics) and noise stream all stay where they were
    (train/trainer.py:315-323).
  * Per-sample extras (labels, the FI score) ride the batches beside x and
    c (train/trainer.py:65-94).
  * The optional per-epoch shuffle (train/trainer.py:326-355) permutes each
    fold's own padded grid, nb_f * B rows, padding rows included; a fold's
    trailing all-padding batches, there only to pad it to the largest
    fold's grid, stay where they are, so ragged folds follow the JAX
    package's sequential per-fold numerics.
  * Constant LR 1e-4 by default; the cyclic schedule is an opt-in (Q1).
  * The logs are each epoch's first-batch loss terms, before that step's
    update (the reference's print cadence, train:201-209).

Batches and noise stay on the device for the whole run: the batches are
uploaded once, and the logs are fetched once at the end of each chunk of
epochs (``TrainSession``: the whole run, a sweep's milestone, or the
stretch between two train-state saves of a resumable run).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.losses import global_row_counts
from .schedules import cyclic_triangular

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
    # "fp32" (parity) or "bf16": the forward in bfloat16 at the JAX
    # package's cast points, fp32 master parameters and Adam state
    # (default_loss_fn; the fused train step runs it on K6)
    precision: str = "fp32"
    # the per-epoch reshuffle (the regression trainer's); the fused train
    # step refuses it
    shuffle: bool = False
    # recompute the loss's forward inside the backward
    # (torch.utils.checkpoint): activation memory for compute, the same
    # values bit for bit
    remat: bool = False


def make_batches(data_list: Sequence[np.ndarray],
                 cov_list: Sequence[np.ndarray], batch_size: int,
                 extras: Optional[dict] = None) -> dict:
    """Pack one fold's per-modality sample arrays into padded batches
    (train/trainer.py:62-95), leading axis n_batches:
      x:      tuple of [NB, B, D_m] per modality
      c:      tuple of [NB, B, c_dim] per modality
      mask:   [NB, B], 1.0 for real rows
      valid:  [NB], True where the batch holds at least one real row
      extras: {name: [NB, B, ...]}, any further per-sample arrays (only
              when ``extras`` is given)
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
    batch = {
        "x": tuple(pack(d) for d in data_list),
        "c": tuple(pack(c) for c in cov_list),
        "mask": mask.reshape(nb, batch_size),
        "valid": mask.reshape(nb, batch_size).sum(axis=1) > 0,
    }
    if extras:
        batch["extras"] = {k: pack(v) for k, v in extras.items()}
    return batch


def full_cast_outputs(fwd: dict) -> dict:
    """A bf16 forward's outputs back to fp32, all but the reconstruction
    means (the JAX trainer's cast points, train/trainer.py:131-152)."""
    def up(v):
        if isinstance(v, (list, tuple)):
            return type(v)(up(t) for t in v)
        return v.float() if v.dtype == torch.bfloat16 else v

    return {k: (v if k == "recon_means" else up(v)) for k, v in fwd.items()}


def default_loss_fn(model, config: TrainConfig) -> LossFn:
    """The ELBO of one batch, per fold: forward (encode, fuse,
    reparameterize with the given eps, decode), then ``model.loss``.

    The JAX default for cvae in fp32 merges each encoder's mu and logvar
    heads into one matmul; the JAX package states that the merged math is
    exact on the CPU, so the port runs the heads as two products.

    With ``precision="bf16"`` the forward runs in bfloat16 at the JAX
    package's cast points (train/trainer.py:131-152): the parameters, x, c
    and the noise cast to bf16 (the module runs on the casts through
    ``torch.func.functional_call``, so the gradients reach the fp32 master
    parameters through the casts), every forward output but the
    reconstruction means cast back to fp32, and the loss reads the fp32
    module. With ``config.remat`` the whole loss is recomputed inside the
    backward (``torch.utils.checkpoint``, JAX's ``jax.checkpoint``): the
    noise and any keep masks are inputs, so the recomputation draws nothing
    and the values are the same bit for bit."""
    if config.precision == "bf16":
        from torch.func import functional_call

        half = torch.bfloat16

        def forward(batch: dict, eps: torch.Tensor) -> dict:
            params = {name: p.to(half) if p.dtype == torch.float32 else p
                      for name, p in model.named_parameters()}
            fwd = functional_call(
                model, params,
                ([x.to(half) for x in batch["x"]],
                 [c.to(half) for c in batch["c"]], config.combine),
                {"eps": eps.to(half)})
            return full_cast_outputs(fwd)
    elif config.precision == "fp32":
        def forward(batch: dict, eps: torch.Tensor) -> dict:
            return model(batch["x"], batch["c"], config.combine, eps=eps)
    else:
        raise ValueError(f"unknown precision {config.precision!r}")

    def loss_fn(batch: dict, eps: torch.Tensor):
        fwd = forward(batch, eps)
        losses = model.loss(batch["x"], fwd, batch["mask"])
        return losses["total"], losses

    if not config.remat:
        return loss_fn
    from torch.utils.checkpoint import checkpoint

    def remat_loss_fn(batch: dict, eps: torch.Tensor):
        return checkpoint(loss_fn, batch, eps, use_reentrant=False,
                          preserve_rng_state=False)

    return remat_loss_fn


# the reference hardcodes batch 256 (train:197); the resume fingerprint
# names another batch size only
DEFAULT_BATCH_SIZE = 256


def add_batch_meta(meta: dict, config: TrainConfig) -> dict:
    """A non-default batch size into a trainer's resume fingerprint
    (train/trainer.py:227-236): a state resumed under another batch size is
    another gradient sequence and is refused."""
    if config.batch_size != DEFAULT_BATCH_SIZE:
        meta["batch"] = str(config.batch_size)
    return meta


def resolve_loss(model, config: TrainConfig, loss_fn: Optional[LossFn]
                 ) -> Tuple[LossFn, dict]:
    """(loss_fn, trajectory fingerprint) of a trainer
    (train/trainer.py:239-257): the given loss, or the default loss when
    none is given, and the flat str->str dict the resume guard compares
    (checkpoints.run_chunked), so that a state is not continued under
    another loss family (the plain loss against the ``--fused_decoder``
    one, say), precision or remat setting."""
    if loss_fn is not None:
        name = getattr(loss_fn, "__qualname__", "custom").split(".")[0]
    else:
        name = "default_loss_fn"
        loss_fn = default_loss_fn(model, config)
    meta = {"loss": name, "precision": config.precision,
            "remat": str(config.remat)}
    return loss_fn, add_batch_meta(meta, config)


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
        self.count = torch.zeros(folds, dtype=self.flat.dtype,
                                 device=self.flat.device)
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
        self.step_flat(self.flatten(grads), valid)

    def flatten(self, grads: Sequence[Optional[torch.Tensor]]
                ) -> torch.Tensor:
        """``grads`` laid out as ``self.flat`` is (None: zeros)."""
        return torch.cat([
            (torch.zeros_like(p) if gr is None else gr).reshape(-1)
            for p, gr in zip(self.params, grads)])

    @torch.no_grad()
    def step_flat(self, g: torch.Tensor, valid: torch.Tensor) -> None:
        """``step`` from the gradients already laid out as ``self.flat`` is:
        every parameter's [F, ...] gradient back to back, in the order of
        ``params``."""
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
    """The random draws of each step, one torch generator per fold on the
    device, all seeded ``seed`` by default (the reference re-seeds 42 per
    fold, so every fold draws the same stream), or fold f seeded
    ``seeds[f]`` (bootstrap replicate b draws from 1000 + b): the
    reparameterization noise, the dropout keep masks of a model with
    dropout, and each epoch's permutation when the trainer shuffles. A fold
    draws noise and keep masks only on a step where its batch is valid, so
    padding batches leave its stream where it was. Tests replay the JAX
    package's draws instead (``ReplayNoise``).

    Under a 'data' mesh axis a rank holds rows ``rows`` = (r0, r1) of each
    batch: it draws the whole batch's noise and masks, as the unmeshed run
    does, and keeps its rows, so the draws are the unmeshed run's.

    ``generators`` (one a fold, on ``device``) are drawn from as they
    stand, in place of generators seeded here."""

    def __init__(self, folds: int, shape: Tuple[int, int], seed: int,
                 device, keep_widths: Sequence[int] = (),
                 keep_prob: float = 1.0,
                 seeds: Optional[Sequence[int]] = None,
                 rows: Optional[Tuple[int, int]] = None,
                 generators: Optional[Sequence[torch.Generator]] = None):
        self.shape = shape
        self.rows = rows
        self.device = device
        self.keep_widths = tuple(keep_widths)
        self.keep_prob = keep_prob
        if generators is not None:
            if len(generators) != folds:
                raise ValueError(f"{len(generators)} generators for {folds} "
                                 "folds")
            self.gens = list(generators)
            return
        if seeds is None:
            seeds = [seed] * folds
        elif len(seeds) != folds:
            raise ValueError(f"{len(seeds)} seeds for {folds} folds")
        self.gens = [torch.Generator(device=device).manual_seed(int(s))
                     for s in seeds]

    def draw(self, valid: np.ndarray) -> torch.Tensor:
        """Noise [F, B, Z] for a step whose per-fold validity is ``valid``
        (host booleans, so drawing needs no device sync)."""
        return torch.stack([
            self._mine(torch.randn(self.shape, generator=gen,
                                   device=self.device)) if ok
            else torch.zeros(self._local(self.shape), device=self.device)
            for gen, ok in zip(self.gens, valid)])

    def _local(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        if self.rows is None:
            return tuple(shape)
        return (self.rows[1] - self.rows[0],) + tuple(shape[1:])

    def _mine(self, draw: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole batch's draw."""
        return draw if self.rows is None else draw[self.rows[0]:self.rows[1]]

    def step(self, t: int, valid: np.ndarray):
        """(noise [F, B, Z], keep masks: one bool [F, B, width] per
        ``keep_widths``) of global step ``t``; each fold draws its noise,
        then its masks."""
        eps = self.draw(valid)
        rows = self.shape[0]
        keeps = [torch.zeros((len(self.gens),) + self._local((rows, w)),
                             dtype=torch.bool, device=self.device)
                 for w in self.keep_widths]
        for f, (gen, ok) in enumerate(zip(self.gens, valid)):
            if ok:
                for keep, w in zip(keeps, self.keep_widths):
                    keep[f] = self._mine(torch.rand(
                        (rows, w), generator=gen,
                        device=self.device) < self.keep_prob)
        return eps, keeps

    def permutation(self, epoch: int, fold_rows: Sequence[int],
                    total: int) -> torch.Tensor:
        """The epoch's row order [F, total]: each fold's first
        ``fold_rows[f]`` rows permuted by its own generator, the rest in
        place."""
        return torch.stack([
            torch.cat([torch.randperm(n, generator=gen, device=self.device),
                       torch.arange(n, total, device=self.device)])
            for gen, n in zip(self.gens, fold_rows)])

    def state(self) -> List[np.ndarray]:
        """Every fold's generator state (uint8), for a train state."""
        return [gen.get_state().numpy() for gen in self.gens]

    def set_state(self, states: Sequence[np.ndarray]) -> None:
        if len(states) != len(self.gens):
            raise ValueError(f"the stored train state holds {len(states)} "
                             f"noise generators, this run {len(self.gens)}")
        for gen, st in zip(self.gens, states):
            gen.set_state(torch.from_numpy(np.asarray(st, np.uint8).copy()))


class ReplayNoise:
    """Given draws in the place of FoldNoise's (tests replay the JAX
    package's threefry draws, which Philox cannot reproduce): ``eps``
    [steps, F, B, Z], ``keeps`` one [steps, F, B, width] per dropout mask,
    ``perms`` [epochs, F, NB * B], each epoch's row order of every fold;
    numpy arrays or tensors on any device."""

    def __init__(self, eps, device, keeps=None, perms=None,
                 dtype=torch.float32):
        self.eps = torch.as_tensor(eps).to(device, dtype)
        self.keeps = [torch.as_tensor(k).to(device, torch.bool)
                      for k in (keeps or ())]
        self.perms = (None if perms is None else
                      torch.as_tensor(perms).to(device, torch.int64))

    def step(self, t: int, valid: np.ndarray):
        return self.eps[t], [k[t] for k in self.keeps]

    def permutation(self, epoch: int, fold_rows: Sequence[int],
                    total: int) -> torch.Tensor:
        if self.perms is None:
            raise ValueError("a shuffled replay needs the permutations "
                             "(perms=)")
        return self.perms[epoch]

    def state(self) -> List[np.ndarray]:
        """Nothing: the draws are indexed by the global step and epoch."""
        return []

    def set_state(self, states: Sequence[np.ndarray]) -> None:
        if len(states):
            raise ValueError("the stored train state holds noise generators; "
                             "a replay has none")


def fold_noise(model, config: TrainConfig, batches, device,
               dtype=torch.float32, eps=None, keeps=None, perms=None,
               seeds=None):
    """The noise of a run over ``batches`` (``DeviceBatches`` or a packed
    layout's): given draws replayed (``ReplayNoise``), or each fold's own
    generator (``FoldNoise``) at the model's ``noise_dim``, with its
    dropout keep masks (``keep_widths``) and ``seeds``. Every trainer of a
    model draws through here, so the padded, grouped and per-modality
    layouts see the same draws."""
    if eps is not None:
        return ReplayNoise(eps, device, keeps, perms, dtype)
    row_slice = getattr(batches, "row_slice", None)
    rows, mine = batches.rows, None
    if row_slice is not None:
        rows, mine = row_slice[2], tuple(row_slice[:2])
    return FoldNoise(
        batches.folds, (rows, model.noise_dim), config.seed, device,
        getattr(model, "keep_widths", ()),
        1.0 - getattr(model, "dropout_rate", 0.0), seeds, mine)


def global_counts(batches: dict, device):
    """A data-sharded run's (parallel.mesh.shard_batches) global row counts
    [NB, F] on ``device`` and its row slice (r0, r1, B), or (None, None)."""
    if "counts" not in batches:
        return None, None
    counts = torch.from_numpy(np.ascontiguousarray(
        np.asarray(batches["counts"], np.float32).T)).to(device)
    return counts, tuple(batches["row_slice"])


class DeviceBatches:
    """Stacked batches ([F, NB, B, ...] numpy, as parallel.folds.
    stack_fold_batches builds them) uploaded once, step-major, so each
    step's slice is a contiguous [F, B, ...] tensor of ``dtype`` (the
    model's). A rank's part of a data-sharded run's batches also carries
    each step's global row ``counts`` and its ``row_slice``."""

    def __init__(self, batches: dict, device, dtype=torch.float32):
        def up(a):
            return torch.from_numpy(np.ascontiguousarray(
                np.swapaxes(np.asarray(a, np.float32), 0, 1))).to(
                    device, dtype)

        self.x = [up(a) for a in batches["x"]]
        self.c = [up(a) for a in batches["c"]]
        self.mask = up(batches["mask"])
        self.extras = {k: up(v) for k, v in batches.get("extras", {}).items()}
        self.valid_host = np.asarray(batches["valid"]).T  # [NB, F]
        self.valid = torch.from_numpy(
            self.valid_host.astype(np.float32)).to(device)
        self.n_batches, self.folds, self.rows = self.mask.shape
        self.counts, self.row_slice = global_counts(batches, device)

    def fold_rows(self) -> List[int]:
        """Each fold's own grid, nb_f * B rows: its valid batches come
        first (stack_fold_batches pads behind them)."""
        return [int(n) * self.rows for n in self.valid_host.sum(axis=0)]

    def permuted(self, order: torch.Tensor) -> "DeviceBatches":
        """These batches with each fold's rows in ``order`` [F, NB * B]
        (train/trainer.py:326-346 per fold): x, c, mask and the extras
        move together. ``valid`` stays as it is: a fold's padding is less
        than one batch and ``order`` keeps its trailing all-padding batches
        in place, so every batch the fold had real rows in still has some.
        """
        nb, folds, rows = self.n_batches, self.folds, self.rows
        take = torch.arange(folds, device=order.device)[:, None]

        def move(a):
            flat = a.transpose(0, 1).reshape((folds, nb * rows) + a.shape[3:])
            return (flat[take, order].reshape((folds, nb, rows) + a.shape[3:])
                    .transpose(0, 1).contiguous())

        out = copy.copy(self)
        out.x = self._move_x(move)
        out.c = [move(a) for a in self.c]
        out.mask = move(self.mask)
        out.extras = {k: move(v) for k, v in self.extras.items()}
        return out

    def _move_x(self, move) -> list:
        """The features with their rows in the permuted order: ``move``
        permutes the rows of an [NB, F, B, ...] tensor."""
        return [move(a) for a in self.x]

    def step(self, t: int) -> dict:
        batch = {"x": [x[t] for x in self.x], "c": [c[t] for c in self.c],
                 "mask": self.mask[t]}
        if self.extras:
            batch["extras"] = {k: v[t] for k, v in self.extras.items()}
        if self.counts is not None:
            batch["counts"] = self.counts[t]
        return batch


StateUpdate = Callable[[dict, torch.Tensor], None]


def run_epochs(loss_fn: LossFn, params: List[torch.nn.Parameter],
               adam: MaskedAdam, batches: DeviceBatches, epochs: int,
               log_keys: Sequence[str], noise, shuffle: bool = False,
               state_update: Optional[StateUpdate] = None,
               first_epoch: int = 0,
               data_sum: Optional[Callable[[torch.Tensor], torch.Tensor]]
               = None,
               row_reduce: Optional[Callable[[torch.Tensor], torch.Tensor]]
               = None) -> torch.Tensor:
    """The epoch loop: every batch of every epoch is one step for all folds.
    It runs epochs ``first_epoch`` to ``first_epoch + epochs - 1`` of the
    run: the global step ``t`` and the epoch index the noise is asked for
    continue from there, so consecutive calls are one run.
    ``noise`` (``FoldNoise``, or ``ReplayNoise`` with given draws) gives
    each step's noise and dropout keep masks (the latter reach the loss as
    the batch's ``keep``), and with ``shuffle`` each epoch's row order.
    Returns the logs [epochs, len(log_keys), F] on the device: the loss
    terms ``log_keys`` (the model's ``log_keys``: total, kl, ll, and jsd
    for mmJSD, tc for mvtCAE) of each epoch's first batch.

    ``state_update(aux, valid)`` applies a step's non-gradient state (the
    BatchNorm running statistics the loss hands back in its aux) after the
    optimizer step, to the folds whose batch is valid.

    A fold whose step is not valid may hand back a NaN loss and gradient
    (mvtCAE's log-sum-exp over an all-padding batch): nothing here scales by
    ``valid``, the optimizer selects, so such a step leaves no trace.

    On a rank of a 'data' mesh axis the batches hold the rank's rows and
    each step's global row ``counts``: the masked means divide by those
    (``ops.losses.global_row_counts``), a batch statistic sums its rows
    over the axis through ``row_reduce`` (differentiable), and ``data_sum``
    sums a tensor in place over the axis, the flat gradient of every step
    and the logged terms, so every rank takes the unmeshed run's step."""
    logs = torch.empty((epochs, len(log_keys), batches.folds),
                       device=batches.mask.device)
    fold_rows = batches.fold_rows() if shuffle else None
    total_rows = batches.n_batches * batches.rows
    t = first_epoch * batches.n_batches
    for epoch in range(epochs):
        epoch_batches = batches
        if shuffle:
            epoch_batches = batches.permuted(noise.permutation(
                first_epoch + epoch, fold_rows, total_rows))
        for step in range(batches.n_batches):
            batch = epoch_batches.step(step)
            noise_t, keeps = noise.step(t, batches.valid_host[step])
            if keeps:
                batch["keep"] = keeps
            with global_row_counts(batch.get("counts"), row_reduce):
                total, aux = loss_fn(batch, noise_t)
                grads = torch.autograd.grad(total.sum(), params,
                                            allow_unused=True)
            if step == 0:
                logs[epoch] = torch.stack([aux[k].detach()
                                           for k in log_keys])
                if data_sum is not None:
                    data_sum(logs[epoch])
            if data_sum is None:
                adam.step(grads, batches.valid[step])
            else:
                adam.step_flat(data_sum(adam.flatten(grads)),
                               batches.valid[step])
            if state_update is not None:
                state_update(aux, batches.valid[step])
            t += 1
            # the step's inputs go before the next step's are asked for: a
            # streamed view frees a consumed shard when its last step's
            # slices are gone (train/streaming.py)
            del batch
    return logs


class TrainSession:
    """One training run that can be continued: the optimizer, the noise,
    the non-gradient ``buffers`` (the end-to-end model's BatchNorm running
    statistics), the epoch cursor and the logs so far. ``run``,
    ``run_milestones`` and ``run_resumable`` of every trainer advance one
    of these, so there is one epoch loop, ``chunk(first_epoch, epochs)``
    (``run_epochs``, or the fused trainer's flat loop), which returns the
    chunk's logs [epochs, len(log_keys), F] on the device."""

    def __init__(self, chunk: Callable[[int, int], torch.Tensor],
                 adam: MaskedAdam, noise, log_keys: Sequence[str],
                 buffers: Optional[dict] = None,
                 params: Optional[dict] = None):
        self.chunk = chunk
        self.adam = adam
        self.noise = noise
        self.log_keys = tuple(log_keys)
        self.buffers = dict(buffers or {})
        self.params = params   # {name: view of adam.flat}, when kept
        # a rank's part of a run on a mesh (parallel.folds.MeshRun): the
        # logs and the train state are gathered into, and restored from,
        # the unmeshed run's layout
        self.layout = None
        self.epoch = 0
        self.start_epoch = 0   # where this process took the run up
        folds = adam.count.shape[0]
        self._logs = {k: np.zeros((folds, 0), np.float32)
                      for k in self.log_keys}

    def advance(self, epochs: int) -> None:
        """Train ``epochs`` more epochs; their logs are fetched at the end
        (the chunk's one deliberate sync)."""
        from ..utils.profiling import annotate

        if epochs <= 0:
            return
        with annotate("mmnm.session.advance"):
            logs = self.chunk(self.epoch, epochs)
            with annotate("mmnm.session.fetch"):
                host = logs.cpu().numpy()
            self._logs = {k: np.concatenate([self._logs[k], host[:, i, :].T],
                                            axis=1)
                          for i, k in enumerate(self.log_keys)}
            self.epoch += epochs

    def logs(self) -> dict:
        """{key: [F, epochs so far]} numpy (on a mesh, every fold's, on
        every rank)."""
        logs = {k: v.copy() for k, v in self._logs.items()}
        return logs if self.layout is None else self.layout.gather_logs(logs)

    def state(self) -> Optional[dict]:
        """The tensors of a train state (numpy). On a mesh they are
        gathered into the unmeshed run's layout on rank 0; the other ranks
        get None."""
        adam = self.adam

        def host(t):
            return t.detach().cpu().numpy()

        state = {"adam": {"flat": host(adam.flat), "m": host(adam.m),
                          "v": host(adam.v), "count": host(adam.count)},
                 "noise": self.noise.state(),
                 "buffers": {k: host(v) for k, v in self.buffers.items()}}
        return state if self.layout is None else self.layout.gather_state(
            state)

    @torch.no_grad()
    def restore(self, tensors: dict, epoch: int, logs: Optional[dict]
                ) -> None:
        """Continue from a stored state. Every tensor is copied into the
        one it replaces: the parameters are views of ``adam.flat``. On a
        mesh each rank takes its part of the stored (unmeshed) state."""
        adam = self.adam
        if self.layout is not None:
            tensors = self.layout.local_state(tensors)
            if logs:
                logs = self.layout.local_logs(logs)

        def put(dst: torch.Tensor, src, what: str) -> None:
            src = np.asarray(src)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(
                    f"the stored train state holds {what} of shape "
                    f"{tuple(src.shape)}, this run's is {tuple(dst.shape)} "
                    "(another architecture, cohort or fold count)")
            dst.copy_(torch.from_numpy(src.copy()))

        stored = tensors["adam"]
        for name in ("flat", "m", "v"):
            put(getattr(adam, name), stored[name], f"adam.{name}")
        count = torch.empty_like(adam.count)
        put(count, stored["count"], "adam.count")
        adam.count = count
        buffers = tensors.get("buffers") or {}
        if sorted(buffers) != sorted(self.buffers):
            raise ValueError(f"the stored train state holds the buffers "
                             f"{sorted(buffers)}, this run "
                             f"{sorted(self.buffers)}")
        for name, buf in self.buffers.items():
            put(buf, buffers[name], name)
        self.noise.set_state(list(tensors.get("noise") or []))
        self.epoch = self.start_epoch = int(epoch)
        folds = adam.count.shape[0]
        logs = logs or {}
        self._logs = {k: np.asarray(logs.get(k, np.zeros((folds, 0))),
                                    np.float32).reshape(folds, -1)
                      for k in self.log_keys}


def _fold_axis(batches: dict) -> dict:
    """One fold's ``make_batches`` output with a leading fold axis of 1
    (what ``parallel.stack_fold_batches`` gives for one fold)."""
    out = {"x": tuple(a[None] for a in batches["x"]),
           "c": tuple(a[None] for a in batches["c"]),
           "mask": batches["mask"][None], "valid": batches["valid"][None]}
    if "extras" in batches:
        out["extras"] = {k: v[None] for k, v in batches["extras"].items()}
    return out


class FoldTrainer:
    """The library's one-fold trainer (train/trainer.py:413-498): a thin
    class over ``parallel.folds.MultiFoldTrainer`` at F = 1, so the port
    keeps one training engine. ``model`` holds one fold
    (``build_model(..., folds=1)``) and trains in place. Each call's
    ``params``, a JAX-layout tree of one fold (the JAX trainer's params),
    is loaded into the model first (None trains the model's own weights);
    the trained parameters come back in that layout, as numpy arrays.

    In the place of JAX's ``key`` stands ``noise``: None (every draw from a
    generator seeded ``config.seed``, as JAX's key defaults to
    PRNGKey(config.seed)), a ``torch.Generator`` on the model's device,
    drawn from as it stands, or a ``FoldNoise`` / ``ReplayNoise``
    (the tests replay JAX's threefry draws, which torch's Philox does not
    reproduce). ``compile()`` is not ported: an eager loop compiles
    nothing."""

    def __init__(self, model, config: TrainConfig, n_samples: int,
                 loss_fn: Optional[LossFn] = None,
                 state_update: Optional[StateUpdate] = None):
        from ..parallel.folds import MultiFoldTrainer

        folds = next(model.parameters()).shape[0]
        if folds != 1:
            raise ValueError(f"FoldTrainer trains one fold; the model holds "
                             f"{folds} (train them at once with "
                             "MultiFoldTrainer)")
        self.model = model
        self.config = config
        self.engine = MultiFoldTrainer(model, config, n_samples, loss_fn,
                                       state_update)
        self.loss_meta = self.engine.loss_meta

    def _load(self, params) -> None:
        if params is not None:
            from ..interop import params_from_jax

            params_from_jax(params, self.model)

    def _draws(self, noise) -> dict:
        """``noise`` as the engine's draw arguments."""
        if noise is None:
            return {}
        if isinstance(noise, (FoldNoise, ReplayNoise)):
            return {"noise": noise}
        if isinstance(noise, torch.Generator):
            model = self.model
            return {"noise": FoldNoise(
                1, (self.config.batch_size, model.noise_dim),
                self.config.seed, noise.device,
                getattr(model, "keep_widths", ()),
                1.0 - getattr(model, "dropout_rate", 0.0),
                generators=[noise])}
        raise TypeError(f"noise is None, a torch.Generator, a FoldNoise or "
                        f"a ReplayNoise, not {type(noise).__name__}")

    def _result(self, logs: dict) -> Tuple[dict, dict]:
        from ..interop import params_to_jax

        return (params_to_jax(self.model, fold=0),
                {k: v[0] for k, v in logs.items()})

    def init_opt_state(self, params=None) -> MaskedAdam:
        """A fresh optimizer over the model's parameters (``params`` loaded
        first): Adam's moments and step count at zero."""
        self._load(params)
        return MaskedAdam(list(self.model.parameters()), self.engine.lr_fn)

    def run(self, params, data_list, cov_list, noise=None,
            extras: Optional[dict] = None) -> Tuple[dict, dict]:
        """Train ``config.epochs`` epochs on one fold's samples; returns
        (params, logs {name: [epochs]})."""
        batches = make_batches(data_list, cov_list, self.config.batch_size,
                               extras)
        return self.run_batches(params, batches, noise)

    def run_batches(self, params, batches: dict, noise=None
                    ) -> Tuple[dict, dict]:
        """``run`` on batches ``make_batches`` built."""
        self._load(params)
        logs = self.engine.run(_fold_axis(batches), **self._draws(noise))
        return self._result(logs)

    def run_resumable(self, params, data_list, cov_list, noise, state_dir,
                      checkpoint_every: int, resume: bool = True,
                      extras: Optional[dict] = None) -> Tuple[dict, dict]:
        """``run`` in chunks of ``checkpoint_every`` epochs with the whole
        train state saved under ``state_dir`` after each; with ``resume``
        a stored state is continued. Equal to ``run`` bit for bit."""
        self._load(params)
        batches = make_batches(data_list, cov_list, self.config.batch_size,
                               extras)
        logs = self.engine.run_resumable(_fold_axis(batches), state_dir,
                                         checkpoint_every, resume,
                                         **self._draws(noise))
        return self._result(logs)


def train_single_fold(model, params, data_list: Sequence[np.ndarray],
                      cov_list: Sequence[np.ndarray], config: TrainConfig,
                      noise=None, extras: Optional[dict] = None,
                      loss_fn: Optional[LossFn] = None,
                      trainer: Optional[FoldTrainer] = None
                      ) -> Tuple[dict, dict]:
    """Train one fold to completion (train/trainer.py:501-515): returns
    (trained params, logs {name: [epochs]}, each epoch's first-batch
    values). ``params`` and ``noise`` are ``FoldTrainer.run``'s. Pass a
    shared ``trainer`` to train several folds through one."""
    if trainer is None:
        trainer = FoldTrainer(model, config, data_list[0].shape[0], loss_fn)
    return trainer.run(params, data_list, cov_list, noise, extras)
