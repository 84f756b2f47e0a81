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
hidden widths that fit the kernels' shared memory (up to 648 in fp32 on
K5's wide-hidden route, 432 in bf16); ``select_kernel`` says why a
configuration is out of it.
"""
from __future__ import annotations

import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.train_step import (
    COMBINES,
    MAX_HIDDEN,
    MAX_MODALITIES,
    FusedTrainStep,
    decoder_tiles,
    smem_bytes,
    wide_hidden_smem_bytes,
    width_limit,
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
    fp32 = config.precision == "fp32"
    args = (model.hidden_dim, model.latent_dim, 4 if fp32 else 16)
    if decoder_tiles(*args, wide_hidden=fp32) is None:
        smem = wide_hidden_smem_bytes(*args) if fp32 else smem_bytes(*args)
        return None, (f"hidden widths {list(model.hidden_dim)} need {smem} B "
                      f"of shared memory per block, over the "
                      f"{_build.MAX_SMEM_BYTES} B an H100 block has "
                      f"({width_limit(fp32)})")
    return ("single" if fp32 else "tiled"), ""


def supported(model, config: TrainConfig) -> Tuple[bool, str]:
    """(ok, reason). ``model`` is the MultimodalCVAE the CLI built."""
    kernel, reason = select_kernel(model, config)
    return kernel is not None, reason


# a block of at least this many elements is copied by torch, which splits
# it over its intra-op threads: at PPMI's 256 x 3485 that took a job's pack
# from 185-211 to 43-54 ms on the H100's host; at ADNI's 256 x 270 the
# threads' start cost more than they saved, and numpy's one thread costs
# less a call
PARALLEL_COPY = 1 << 18


def _torch_view(a) -> Optional[torch.Tensor]:
    """A CPU tensor over ``a``'s memory, or None where torch cannot take
    one (negative strides, another byte order, not a numpy array)."""
    try:
        return torch.from_numpy(a)
    except (TypeError, ValueError):
        return None


def _clear(block: np.ndarray, rows: int, cols: int, written: list) -> None:
    """Zero what ``block`` held in its first ``written`` [rows, columns]
    outside its first ``rows`` x ``cols``; those become ``written``."""
    r0, c0 = written
    if r0 > rows:
        block[rows:r0, :c0] = 0.0
    if c0 > cols:
        block[:min(rows, r0), cols:c0] = 0.0
    written[:] = rows, cols


class BatchPacker:
    """A job's rows in the step's batch layout, written step-major: step
    ``t`` of every fold is one slab, x [F, M, Bp, Dp] and c [F, Bp, Cp],
    rows padded to ``row_align`` and the feature and covariate widths to
    ``col_align``. Folds are padded to the largest fold's batch count with
    all-padding batches (train/fused.py:109-142 for one fold). ``meta``
    gives rm [NB, F, Bp], nvalid [NB, F] = max(rows, 1) and valid [NB, F]
    for the whole job."""

    def __init__(self, step: FusedTrainStep,
                 per_fold_data: Sequence[Sequence[np.ndarray]],
                 per_fold_cov: Sequence[np.ndarray], batch_size: int):
        c_dim = per_fold_cov[0].shape[1]
        if c_dim != step.C:
            raise ValueError(f"covariates of width {c_dim}, the model's are "
                             f"{step.C}")
        modalities = step.model.modalities
        if any(len(d) != modalities for d in per_fold_data):
            raise ValueError(f"{[len(d) for d in per_fold_data]} modalities "
                             f"a fold, the model's are {modalities}")
        self.data, self.cov, self.batch_size = (per_fold_data, per_fold_cov,
                                                batch_size)
        with warnings.catch_warnings():
            # a read-only array is only read from
            warnings.simplefilter("ignore", UserWarning)
            self.views = [[_torch_view(d) if batch_size * d.shape[1]
                           >= PARALLEL_COPY else None for d in data_list]
                          for data_list in per_fold_data]
        sizes = np.array([d[0].shape[0] for d in per_fold_data])
        self.n_batches = max(1, -(-int(sizes.max()) // batch_size))
        folds, bp = len(per_fold_data), (-(-batch_size // step.row_align)
                                         * step.row_align)
        self.slab_shapes = ((folds, modalities, bp, step.Dp),
                            (folds, bp, step.Cp))
        starts = np.arange(self.n_batches)[:, None] * batch_size
        self.counts = np.clip(sizes[None, :] - starts, 0, batch_size)

    def nothing_written(self) -> list:
        """``pack``'s ``written`` for slabs of zeros."""
        folds, modalities = self.slab_shapes[0][:2]
        return [[[0, 0] for _ in range(modalities + 1)] for _ in range(folds)]

    def pack(self, t: int, x: torch.Tensor, c: torch.Tensor,
             written: list) -> None:
        """Step ``t`` into the float32 CPU slabs ``x`` and ``c``, which read
        zero but in ``written`` [F][M + 1][2]: the first rows and columns
        of each block (a modality's [Bp, Dp], then the covariates' [Bp, Cp])
        that a pack filled before. What is left there outside this step's
        rows is zeroed, and ``written`` becomes what this step filled, so
        a slab reused job after job keeps nothing of an earlier one."""
        xn, cn = x.numpy(), c.numpy()
        lo = t * self.batch_size
        for f, (data_list, cov) in enumerate(zip(self.data, self.cov)):
            rows = int(self.counts[t, f])
            for mi, (d, view) in enumerate(zip(data_list, self.views[f])):
                block, cols = xn[f, mi], d.shape[1]
                if view is not None and rows * cols >= PARALLEL_COPY:
                    x[f, mi, :rows, :cols].copy_(view[lo:lo + rows])
                else:
                    block[:rows, :cols] = d[lo:lo + rows]
                _clear(block, rows, cols, written[f][mi])
            block, cols = cn[f], cov.shape[1]
            block[:rows, :cols] = cov[lo:lo + rows]
            _clear(block, rows, cols, written[f][-1])

    def pack_all(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every step: x [NB, F, M, Bp, Dp], c [NB, F, Bp, Cp]."""
        x, c = (torch.zeros((self.n_batches,) + s, dtype=torch.float32)
                for s in self.slab_shapes)
        for t in range(self.n_batches):
            self.pack(t, x[t], c[t], self.nothing_written())
        return x, c

    def meta(self) -> dict:
        rows = self.slab_shapes[1][1]
        counts = self.counts.astype(np.float32)
        return {"rm": (np.arange(rows) < self.counts[..., None]).astype(
                    np.float32),
                "nvalid": np.maximum(counts, 1.0), "valid": counts > 0}


class PackedDeviceBatches:
    """A job's batches on the device, step-major (``BatchPacker``'s layout
    with the step first: x [NB, F, M, Bp, Dp], c [NB, F, Bp, Cp], rm [NB, F,
    Bp], nvalid [NB, F]), x and c in the step's storage dtype; the interface
    train.trainer.run_epochs reads."""

    def __init__(self, x: torch.Tensor, c: torch.Tensor, meta: dict,
                 step: FusedTrainStep, device: torch.device):
        stored = step.cast_batch({"x": x, "c": c})
        self.x, self.c = stored["x"], stored["c"]
        self.valid_host = meta["valid"]                      # [NB, F]
        # rm, nvalid and valid (each step's row contiguous: MaskedAdam reads
        # it in place) in one copy; to a card from page-locked memory,
        # without a wait
        parts = [meta["rm"], meta["nvalid"], meta["valid"].astype(np.float32)]
        flat = torch.from_numpy(np.concatenate([a.ravel() for a in parts]))
        if device.type == "cuda":
            flat = flat.pin_memory()
        flat = flat.to(device, non_blocking=True)
        sizes = [a.size for a in parts]
        self.rm, self.nvalid, self.valid = (
            v.view(a.shape) for v, a in zip(flat.split(sizes), parts))
        self.mask = self.rm
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
        # the card's staging ring (``_stage``): slabs copied up through it,
        # and the times it was made
        self.staging_counts = {"slabs": 0, "allocations": 0}
        self._ring, self._ring_key = [], None

    def batches(self, per_fold_data, per_fold_cov, device):
        """Every fold's per-modality sample arrays as the job's
        ``PackedDeviceBatches``. On a card, step by step through the
        trainer's ring of page-locked slabs (``_stage``); elsewhere packed
        whole on the host and moved (on the CPU, kept as packed)."""
        from ..utils.profiling import annotate

        device = torch.device(device)
        with annotate("mmnm.fused.batches"):
            with annotate("mmnm.fused.pack"):
                packer = BatchPacker(self.step, per_fold_data, per_fold_cov,
                                     self.config.batch_size)
                if device.type == "cuda":
                    x, c = self._stage(packer, device)
                else:
                    x, c = (a.to(device) for a in packer.pack_all())
            with annotate("mmnm.fused.upload"):
                return PackedDeviceBatches(x, c, packer.meta(), self.step,
                                           device)

    def _stage(self, packer: BatchPacker, device: torch.device):
        """The job's x and c on the card through a ring of two page-locked
        slabs of one step each, held from job to job (made again only for
        another slab shape or device). Step ``t`` is packed into its slab
        once the slab's previous copy has left it, then copied up without a
        wait on the current stream, so the host packs a step while the one
        before goes up; the steps queued after read whole batches."""
        key = (packer.slab_shapes, device)
        if self._ring_key != key:
            for *_, sent, _ in self._ring:
                sent.synchronize()
            self._ring = [tuple(torch.zeros(s, dtype=torch.float32,
                                            pin_memory=True)
                                for s in packer.slab_shapes)
                          + (torch.cuda.Event(), packer.nothing_written())
                          for _ in range(2)]
            self._ring_key = key
            self.staging_counts["allocations"] += 1
        x, c = (torch.empty((packer.n_batches,) + s, dtype=torch.float32,
                            device=device) for s in packer.slab_shapes)
        stream = torch.cuda.current_stream(device)
        for t in range(packer.n_batches):
            x_slab, c_slab, sent, written = self._ring[t % 2]
            sent.synchronize()
            packer.pack(t, x_slab, c_slab, written)
            x[t].copy_(x_slab, non_blocking=True)
            c[t].copy_(c_slab, non_blocking=True)
            sent.record(stream)
            self.staging_counts["slabs"] += 1
        return x, c

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
