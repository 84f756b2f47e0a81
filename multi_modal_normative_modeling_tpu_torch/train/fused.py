"""Fold-parallel training on the fused train step (counterpart of
train/fused.py).

Every optimizer step's forward and backward is one call of the fused step
(``kernels/train_step.py``, K5, in fp32; ``kernels/train_step_tiled.py``,
K6, in bf16) on the packed layout (``models/stacked.py``). The parameters
are packed once, trained in the step's layout with the port's MaskedAdam
(one step count per fold, the all-padding-batch skip) and unpacked once
after training, so checkpoints and the test stage are unchanged. Padded
entries have zero gradients, so Adam keeps them at exactly zero. The noise
of every step is the plain trainer's (``FoldNoise``, or replayed ``eps``),
so the trajectories of every fold are comparable step for step with
``MultiFoldTrainer``'s.

Scope: variant cvae (cVAE_multimodal), fusion poe, gpoe, moe or mopoe,
1 to 3 hidden layers, no shuffle, covariates shared by every modality, and
hidden widths that fit the kernels' shared memory; ``select_kernel`` says
why a configuration is out of it.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.train_step import (
    COMBINES,
    MAX_HIDDEN,
    MAX_MODALITIES,
    FusedTrainStep,
    smem_bytes,
)
from ..kernels import _build
from ..models.stacked import StackedMultimodalCVAE
from .checkpoints import run_chunked
from .trainer import (
    FoldNoise,
    MaskedAdam,
    ReplayNoise,
    TrainConfig,
    TrainSession,
    add_batch_meta,
    build_lr_fn,
    run_epochs,
)


def select_kernel(model, config: TrainConfig) -> Tuple[Optional[str], str]:
    """(kernel, reason): 'single' (K5, fp32), 'tiled' (K6, bf16), or None
    with the reason the fused step cannot train this configuration. The
    same routing holds on the CPU (plain versions) and on the card."""
    variant = getattr(model, "variant", None)
    if variant != "cvae":
        return None, f"model variant {variant!r} (the fused step is cvae)"
    if config.combine.lower() not in COMBINES:
        return None, f"fusion {config.combine!r}"
    if config.precision not in ("fp32", "bf16"):
        return None, f"precision {config.precision!r}"
    if config.shuffle:
        return None, "shuffle=True (the fused path trains in batch order)"
    if not getattr(model, "non_linear", True):
        return None, "linear layers (the fused step runs LeakyReLU)"
    if not 1 <= len(model.hidden_dim) <= MAX_HIDDEN:
        return None, (f"{len(model.hidden_dim)} hidden layers (the fused "
                      f"step takes 1 to {MAX_HIDDEN})")
    if model.modalities > MAX_MODALITIES:
        return None, f"{model.modalities} modalities (at most {MAX_MODALITIES})"
    smem = smem_bytes(model.hidden_dim, model.latent_dim,
                      16 if config.precision == "bf16" else 4)
    if smem > _build.MAX_SMEM_BYTES:
        return None, (f"hidden widths {list(model.hidden_dim)} need {smem} B "
                      f"of shared memory per block, over the "
                      f"{_build.MAX_SMEM_BYTES} B an H100 block has")
    return ("tiled" if config.precision == "bf16" else "single"), ""


def supported(model, config: TrainConfig) -> Tuple[bool, str]:
    """(ok, reason). ``model`` is the MultimodalCVAE the CLI built."""
    kernel, reason = select_kernel(model, config)
    return kernel is not None, reason


def make_packed_batches(step: FusedTrainStep,
                        per_fold_data: Sequence[Sequence[np.ndarray]],
                        per_fold_cov: Sequence[np.ndarray],
                        batch_size: int) -> dict:
    """Every fold's per-modality sample arrays in the step's batch layout,
    padded once (numpy, fold-major; rows to ``row_align``, the feature and
    covariate widths to ``col_align``): x [F, NB, M, Bp, Dp], c [F, NB, Bp,
    Cp], rm [F, NB, Bp], nvalid [F, NB] = max(rows, 1), valid [F, NB]. Folds
    are padded to the largest fold's batch count with all-padding batches
    (train/fused.py:109-142 for one fold)."""
    m = step.model
    folds = len(per_fold_data)
    max_n = max(d[0].shape[0] for d in per_fold_data)
    nb = max(1, -(-max_n // batch_size))
    bp = -(-batch_size // step.row_align) * step.row_align
    c_dim = per_fold_cov[0].shape[1]
    if c_dim != step.C:
        raise ValueError(f"covariates of width {c_dim}, the model's are "
                         f"{step.C}")
    x = np.zeros((folds, nb, m.modalities, bp, step.Dp), np.float32)
    c = np.zeros((folds, nb, bp, step.Cp), np.float32)
    rm = np.zeros((folds, nb, bp), np.float32)
    counts = np.zeros((folds, nb), np.float32)
    for f, (data_list, cov) in enumerate(zip(per_fold_data, per_fold_cov)):
        n = data_list[0].shape[0]
        for b in range(nb):
            lo, hi = b * batch_size, min(n, (b + 1) * batch_size)
            rows = hi - lo
            if rows <= 0:
                continue
            for mi, d in enumerate(data_list):
                x[f, b, mi, :rows, :d.shape[1]] = d[lo:hi]
            c[f, b, :rows, :c_dim] = cov[lo:hi]
            rm[f, b, :rows] = 1.0
            counts[f, b] = rows
    return {"x": x, "c": c, "rm": rm, "nvalid": np.maximum(counts, 1.0),
            "valid": counts > 0}


class PackedDeviceBatches:
    """``make_packed_batches`` output uploaded once, step-major, in the
    step's storage dtype; the interface train.trainer.run_epochs reads."""

    def __init__(self, batches: dict, step: FusedTrainStep, device):
        def up(a):
            return torch.from_numpy(np.ascontiguousarray(
                np.swapaxes(np.asarray(a, np.float32), 0, 1))).to(device)

        stored = step.cast_batch({"x": up(batches["x"]),
                                  "c": up(batches["c"])})
        self.x, self.c = stored["x"], stored["c"]
        self.rm = up(batches["rm"])
        self.nvalid = up(batches["nvalid"])
        self.mask = self.rm
        self.valid_host = np.asarray(batches["valid"]).T       # [NB, F]
        self.valid = torch.from_numpy(
            self.valid_host.astype(np.float32)).to(device)
        self.n_batches, self.folds, self.rows = self.rm.shape

    def step(self, t: int) -> dict:
        return {"x": self.x[t], "c": self.c[t], "rm": self.rm[t],
                "nvalid": self.nvalid[t]}


class FusedFoldTrainer:
    """Trains every fold at once on the fused step. ``run`` takes and
    returns the packed tree (``interop.packed_from_model`` /
    ``packed_to_model`` convert to and from the fold-stacked module)."""

    def __init__(self, model, config: TrainConfig, n_samples: int,
                 tile_b: Optional[int] = None):
        kernel, reason = select_kernel(model, config)
        if kernel is None:
            raise ValueError(f"fused train step unsupported: {reason}")
        self.kernel = kernel
        self.stacked = StackedMultimodalCVAE(
            model.input_dim_list, model.hidden_dim, model.latent_dim,
            model.c_dim, model.modalities, model.non_linear)
        self.config = config
        # the fused step is cvae's: its terms are the model's own log keys
        self.log_keys = model.log_keys
        if kernel == "tiled":
            from ..kernels.train_step_tiled import TiledFusedTrainStep

            self.step = TiledFusedTrainStep(
                self.stacked, config.combine, tile_b=tile_b,
                compute_dtype=torch.bfloat16, batch_hint=config.batch_size)
        else:
            self.step = FusedTrainStep(self.stacked, config.combine)
        self.lr_fn = build_lr_fn(config, n_samples)
        # the resume fingerprint (train/fused.py:174-182): a state of one
        # kernel or precision is not continued under the other
        self.loss_meta = add_batch_meta(
            {"loss": f"fused_kernel_{kernel}",
             "precision": config.precision}, config)
        self.resumed_from = 0   # the epoch run_resumable took the run up at

    def batches(self, per_fold_data, per_fold_cov, device):
        from ..utils.profiling import annotate

        with annotate("mmnm.fused.batches"):
            with annotate("mmnm.fused.pack"):
                packed = make_packed_batches(self.step, per_fold_data,
                                             per_fold_cov,
                                             self.config.batch_size)
            with annotate("mmnm.fused.upload"):
                return PackedDeviceBatches(packed, self.step, device)

    def session(self, packed: dict, batches: PackedDeviceBatches,
                eps=None, through_autograd: bool = False) -> TrainSession:
        """A new run from ``packed`` (fold-stacked, on the batches' device).
        ``eps`` [epochs * NB, F, batch_size, Z] replays given noise; by
        default each fold draws its own. The session's Adam holds the fp32
        master parameters (``flat``) the step trains, in the padded layout;
        ``trained(session)`` unpads them.

        The loss the trainers minimize is the plain sum of the folds'
        totals, so the step's gradients are the update's: they go from the
        step to MaskedAdam as the one flat buffer the kernel wrote, with no
        autograd graph. ``through_autograd`` takes the long way instead
        (``StepFunction`` under ``run_epochs``, which scales every gradient
        by the incoming one and concatenates them again); both ways give
        the same trajectory bit for bit."""
        from ..utils.profiling import annotate

        with annotate("mmnm.fused.session"):
            device = batches.rm.device
            named = self.step.pad_params(packed)
            names = self.step._param_names
            wrap = torch.nn.Parameter if through_autograd else (lambda t: t)
            params = [wrap(named[k].detach().float().clone())
                      for k in names]
            if eps is not None:
                noise = ReplayNoise(eps, device)
            else:
                noise = FoldNoise(batches.folds, (self.config.batch_size,
                                                  self.stacked.latent_dim),
                                  self.config.seed, device)
            adam = MaskedAdam(params, self.lr_fn)
        views = dict(zip(names, params))
        if through_autograd:
            loss_fn = self.step.loss_fn(params)

            def chunk(first_epoch, epochs):
                return run_epochs(loss_fn, params, adam, batches, epochs,
                                  self.log_keys, noise,
                                  first_epoch=first_epoch)
        else:
            def chunk(first_epoch, epochs):
                return self._run_flat(views, adam, batches, noise, epochs,
                                      first_epoch)

        return TrainSession(chunk, adam, noise, self.log_keys, params=views)

    def trained(self, session: TrainSession) -> dict:
        """The session's parameters as the packed tree, unpadded."""
        from ..utils.profiling import annotate

        with annotate("mmnm.fused.trained"):
            return self.step.unpad_named({k: p.detach() for k, p
                                          in session.params.items()})

    def run(self, packed: dict, batches: PackedDeviceBatches,
            eps=None, through_autograd: bool = False) -> Tuple[dict, dict]:
        """Train ``packed`` for ``config.epochs`` epochs (the arguments are
        ``session``'s). Returns (the trained packed tree, logs {total, kl,
        ll: [F, epochs]})."""
        session = self.session(packed, batches, eps, through_autograd)
        session.advance(self.config.epochs)
        return self.trained(session), session.logs()

    def run_resumable(self, packed: dict, batches: PackedDeviceBatches,
                      state_dir, checkpoint_every: int, resume: bool = True,
                      eps=None) -> Tuple[dict, dict]:
        """``run`` in chunks of ``checkpoint_every`` epochs
        (train/fused.py:293-324), one whole-run train state under
        ``state_dir`` (the fp32 master parameters in the padded layout,
        Adam's moments and counts, the noise generators, the epoch cursor)
        saved after each; with ``resume`` a stored state is continued, and
        one written under another kernel, precision or batch size is
        refused. ``resumed_from`` is the epoch this call took the run up
        at."""
        session = self.session(packed, batches, eps)
        run_chunked(state_dir, self.config.epochs, checkpoint_every, resume,
                    session, self.loss_meta)
        self.resumed_from = session.start_epoch
        return self.trained(session), session.logs()

    @torch.no_grad()
    def _run_flat(self, named: dict, adam: MaskedAdam,
                  batches: PackedDeviceBatches, noise, epochs: int,
                  first_epoch: int = 0) -> torch.Tensor:
        """train.trainer.run_epochs without autograd: ``named`` are views
        of ``adam.flat``, and each step's flat gradient updates it. Under a
        profiler each step is an ``mmnm.step`` range holding its phases."""
        from ..utils.profiling import annotate

        logs = torch.empty((epochs, len(self.log_keys), batches.folds),
                           device=batches.rm.device)
        t = first_epoch * batches.n_batches
        for epoch in range(epochs):
            for i in range(batches.n_batches):
                with annotate("mmnm.step"):
                    with annotate("mmnm.step.inputs"):
                        noise_t, _ = noise.step(t, batches.valid_host[i])
                        b = batches.step(i)
                        eps = self.step.pad_eps(noise_t)
                    with annotate("mmnm.step.kernel"):
                        losses, flat = self.step.loss_and_grads_flat(
                            named, b["x"], b["c"], eps, b["rm"],
                            b["nvalid"])
                    if i == 0:
                        with annotate("mmnm.step.log"):
                            logs[epoch] = torch.stack(
                                [losses[k] for k in self.log_keys])
                    with annotate("mmnm.step.adam"):
                        adam.step_flat(flat, batches.valid[i])
                    t += 1
        return logs
