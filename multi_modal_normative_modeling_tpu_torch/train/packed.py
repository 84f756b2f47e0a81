"""Training on the packed-modality layouts (counterpart of train/packed.py).

``--packed_xla`` trains on a layout where every layer is one batched
product over the modality axis: the padded layout of models/stacked.py
here, the width-grouped one of models/grouped.py (train/grouped.py), and
the layouts of the DMVAE family, the end-to-end model and the regression
(train/grouped_dmvae.py, train/packed_endtoend.py,
train/packed_regression.py). The JAX package computes these layouts with
XLA einsums and runs no Pallas kernel on them; the port computes them with
batched torch products.

``PackedMultiFoldTrainer`` trains every fold at once, as the port's
``MultiFoldTrainer`` does: the JAX package's sequential per-fold packed
trainers and its fold-parallel ones follow the same trajectory, so both
map onto it. It packs the fold-stacked model's parameters once
(``interop.packed_from_model``), trains the packed tree through the plain
trainer's machinery (``train/trainer.py``: ``run_epochs``, ``MaskedAdam``,
the noise of ``fold_noise``, ``TrainSession``), and writes the result back
into the model, so the CLIs' checkpoint writer and the test stage do not
change. A model's head that the layout does not pack (the end-to-end
classifier, the regression MLP) trains in place beside the packed tree.
Every step draws its noise through the same calls as ``MultiFoldTrainer``
(``FoldNoise``: shape [F, B, noise_dim], the same order, the same valid
flags), so a packed run and a per-modality run see identical draws.

``precision='bf16'`` (cvae only) runs the forward in bfloat16 with fp32
master parameters, at the JAX package's cast points: the parameters, x and
c cast to bf16, every forward output but the reconstruction means cast back
to fp32, the loss on the fp32 parameters.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..interop import packed_to_jax, params_from_jax, params_to_jax
from ..models.stacked import StackedMultimodalCVAE
from ..ops.shard import modality_shard, part
from ..parallel.folds import MultiFoldTrainer
from ..parallel.mesh import shard_batches
from .checkpoints import run_chunked
from .trainer import (
    DeviceBatches,
    FoldNoise,
    MaskedAdam,
    TrainConfig,
    TrainSession,
    add_batch_meta,
    build_lr_fn,
    fold_noise,
    full_cast_outputs,
    make_batches,
    run_epochs,
)

SKELETON = ("cvae", "mmjsd", "mvtcae", "nmmlp")
DMVAE_FAMILY = ("dmvae", "weighted", "mmvaeplus")


def packed_supported(model, config: TrainConfig) -> Tuple[bool, str]:
    """(ok, reason) of the packed layouts for ``model`` under ``config``,
    in the JAX package's words (train/packed.py:35-60)."""
    if getattr(model, "variant", None) not in SKELETON + DMVAE_FAMILY:
        return False, (f"model variant {getattr(model, 'variant', None)!r} "
                       "(packed supports the cvae skeleton "
                       "cvae/mmjsd/mvtcae/nmmlp and the DMVAE family)")
    if config.precision == "bf16" \
            and getattr(model, "variant", None) != "cvae":
        return False, ("bf16 packed path is cvae-only (the mmjsd/mvtcae "
                       "regularizers have no half-precision parity story)")
    if config.combine.lower() not in ("poe", "gpoe", "moe", "mopoe"):
        return False, f"fusion {config.combine!r}"
    if config.precision not in ("fp32", "bf16"):
        return False, f"precision {config.precision!r}"
    if config.shuffle:
        return False, "shuffle=True (packed layout has no reshuffle path)"
    return True, ""


def _pack_fold_batches(layout, data_list: Sequence[np.ndarray],
                       cov: np.ndarray, batch_size: int,
                       extras: Optional[dict] = None) -> dict:
    """One fold's per-modality arrays -> {x (the layout's packed features,
    numpy), c [NB, B, C], mask [NB, B], valid [NB]}, and ``extras``."""
    b = make_batches(data_list, [cov], batch_size, extras)
    x = layout.pack_inputs(b["x"])
    b["x"] = (x.numpy() if isinstance(x, torch.Tensor)
              else tuple(g.numpy() for g in x))
    b["c"] = b["c"][0]
    return b


def make_packed_fold_batches(stacked: StackedMultimodalCVAE,
                             data_list: Sequence[np.ndarray],
                             cov: np.ndarray, batch_size: int) -> dict:
    """One fold's per-modality arrays -> {x [NB, M, B, d_max], c [NB, B, C],
    mask [NB, B], valid [NB]} (train/packed.py:63-86), numpy."""
    return _pack_fold_batches(stacked, data_list, cov, batch_size)


class PackedBatches(DeviceBatches):
    """``parallel.stack_fold_batches`` output in a packed layout, uploaded
    once, step-major: ``x`` holds one [NB, F, G, B, d] tensor per width
    group (the padded layout's one [NB, F, M, B, d_max]), ``c`` the one
    covariate block [NB, F, B, C] every modality shares (the CLIs check
    that the blocks agree), and mask, valid and extras as DeviceBatches
    holds them. A permutation moves every per-sample leaf, the features on
    their sample axis 3 (the grouped shuffle)."""

    def __init__(self, batches: dict, layout, device, dtype=torch.float32):
        host = dict(batches, x=(), c=tuple(batches["c"][:1]))
        super().__init__(host, device, dtype)
        x = layout.pack_inputs([np.asarray(a, np.float32)
                                for a in batches["x"]])
        groups = (x,) if isinstance(x, torch.Tensor) else x
        self.x = [g.transpose(0, 1).contiguous().to(device, dtype)
                  for g in groups]

    def _move_x(self, move) -> list:
        return [move(g.transpose(2, 3)).transpose(2, 3).contiguous()
                for g in self.x]

    def step(self, t: int) -> dict:
        batch = {"x": tuple(g[t] for g in self.x), "c": self.c[0][t],
                 "mask": self.mask[t]}
        if self.extras:
            batch["extras"] = {k: v[t] for k, v in self.extras.items()}
        if self.counts is not None:
            batch["counts"] = self.counts[t]
        return batch


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree`` with its leaves replaced, in ``_leaves`` order."""
    it = iter(leaves)

    def go(node):
        if isinstance(node, dict):
            return {k: go(node[k]) for k in node}
        if isinstance(node, (list, tuple)):
            return [go(v) for v in node]
        return next(it)

    return go(tree)


def half_cast(tree):
    """fp32 leaves -> bf16 (the JAX trainer's _half_cast)."""
    return _rebuild(tree, [t.to(torch.bfloat16)
                           if t.dtype == torch.float32 else t
                           for t in _leaves(tree)])


class PackedMultiFoldTrainer:
    """Trains every fold of a fold-stacked model at once on the padded
    packed layout (models/stacked.py). Subclasses swap the layout
    (``_build_layout``), its loss (``_loss``), the resume fingerprint's
    loss name (``_loss_name``) and the model's head trained beside it
    (``_head``).

    ``run``, ``run_milestones`` and ``run_resumable`` take the batches
    ``stack_fold_batches`` builds (or ``prepare_batches`` output) and the
    draws ``MultiFoldTrainer`` takes; the model ends up trained in place.
    ``config.shuffle`` permutes each fold's rows every epoch on any layout
    (``PackedBatches.permuted``); the JAX routing takes it for the
    regression only (``packed_supported`` refuses it).

    With ``mesh`` (a ('fold', 'modality', 'data') mesh of
    parallel/modality.py) every rank runs this trainer on the same
    arguments, as ``MultiFoldTrainer(mesh=)`` does: ``shardings_fn(mesh,
    folds, batch rows)`` plans what a rank holds (its folds, its rows, its
    part of each leaf's modality axis; ``packed_fold_shardings`` and its
    kin), and the run is the unmeshed run up to the order of the partial
    sums. The model comes back whole on every rank; the mesh joins the
    resume fingerprint."""

    # the ranks along 'data' draw noise of their own (EPFoldTrainer)
    noise_per_data = False

    def __init__(self, model, config: TrainConfig, n_samples: int,
                 mesh=None, shardings_fn: Optional[Callable] = None):
        self.model = model
        self.config = config
        self.layout = self._build_layout(model)
        self.lr_fn = build_lr_fn(config, n_samples)
        self.log_keys = model.log_keys
        # the resume fingerprint: each layout is its own trajectory family,
        # and the port keeps one whole-run state (not one per fold)
        self.loss_meta = add_batch_meta(
            {"loss": self._loss_name(), "precision": config.precision,
             "state": "whole-run"}, config)
        self.resumed_from = 0
        self.mesh = mesh
        self._run = None   # while split over the mesh
        if mesh is not None:
            from ..parallel.modality import packed_fingerprint

            if shardings_fn is None:
                raise ValueError("a packed trainer on a mesh needs its "
                                 "shardings plan (parallel/modality.py)")
            if mesh.axis("data") > 1 and config.shuffle:
                raise ValueError("the per-epoch shuffle permutes rows "
                                 "across the 'data' mesh axis's shards: "
                                 "train it without a data axis")
            self.shardings_fn = shardings_fn
            self.loss_meta["mesh"] = packed_fingerprint(mesh)

    # -- layout hooks -------------------------------------------------------
    def _build_layout(self, model):
        return StackedMultimodalCVAE(
            model.input_dim_list, model.hidden_dim, model.latent_dim,
            model.c_dim, model.modalities, model.non_linear,
            variant=model.variant,
            jsd_on_fused=getattr(model, "jsd_on_fused", True))

    def _loss_name(self) -> str:
        v = self.layout.variant
        return "packed_stacked" if v == "cvae" else f"packed_stacked_{v}"

    def _x(self, batch):
        return batch["x"][0]

    def _loss(self, packed, batch, eps):
        layout, combine = self.layout, self.config.combine
        x, c = self._x(batch), batch["c"]
        if self.config.precision == "bf16":
            x16 = (x.to(torch.bfloat16) if isinstance(x, torch.Tensor)
                   else tuple(g.to(torch.bfloat16) for g in x))
            fwd = full_cast_outputs(layout.forward(
                half_cast(packed), x16, c.to(torch.bfloat16), combine, eps))
        else:
            fwd = layout.forward(packed, x, c, combine, eps)
        losses = layout.loss(packed, x, fwd, batch["mask"])
        return losses["total"], losses

    def _head(self) -> Optional[torch.nn.Module]:
        """The model's part that trains in place beside the packed tree."""
        return None

    state_update = None

    # -- runs ---------------------------------------------------------------
    def prepare_batches(self, stacked_batches) -> PackedBatches:
        """The packed batches of ``stack_fold_batches`` output, on the
        model's device: they depend on the cohort and the batch size only,
        so a sweep builds them once per procedure. On a mesh, this rank's
        part of them."""
        if isinstance(stacked_batches, PackedBatches):
            if self._run is not None:
                raise ValueError("a run on a mesh takes stack_fold_batches "
                                 "output, not packed batches")
            return stacked_batches
        device = next(self.model.parameters()).device
        if self._run is None:
            return PackedBatches(stacked_batches, self.layout, device)
        plan = self._run.plan
        batches = PackedBatches(shard_batches(stacked_batches, plan),
                                self.layout, device)
        if plan.shard_x:
            with modality_shard(self._run.shard):
                batches.x = [part(g, g.shape[2], 2).contiguous()
                             for g in batches.x]
        return batches

    # the model's folds split over the mesh for a run, gathered whole at
    # its end (the packed tree is split in ``session``)
    on_mesh = MultiFoldTrainer.on_mesh

    def _mesh_run(self, plan):
        from ..parallel.modality import PackedMeshRun

        return PackedMeshRun(self.model, self.mesh, plan,
                             noise_per_data=self.noise_per_data)

    def _noise(self, batches, device, eps, keeps, perms, seeds):
        run = self._run
        if run is not None:
            draws = run.draws(dict(eps=eps, keeps=keeps, perms=perms,
                                   seeds=seeds))
            eps, keeps, perms, seeds = (draws[k] for k in
                                        ("eps", "keeps", "perms", "seeds"))
            if self.noise_per_data and eps is None:
                from ..parallel.modality import data_seed

                # data shard d draws its own rows from (seed, d): JAX's
                # fold_in of the data index (parallel/modality.py:449-452)
                folds = batches.folds
                base = seeds if seeds is not None else \
                    [self.config.seed] * folds
                seeds = [data_seed(s, self.mesh.index("data")) for s in base]
                return FoldNoise(folds, (batches.rows, self.model.noise_dim),
                                 self.config.seed, device, seeds=seeds)
        return fold_noise(self.model, self.config, batches, device,
                          torch.float32, eps, keeps, perms, seeds)

    def session(self, stacked_batches, eps=None, keeps=None, perms=None,
                seeds=None) -> TrainSession:
        """A new run from the model's parameters, packed (the arguments are
        MultiFoldTrainer.session's). ``session.packed`` is the packed tree
        the run trains; ``write_back`` puts it into the model."""
        from ..interop import packed_from_model

        batches = self.prepare_batches(stacked_batches)
        device = batches.mask.device
        noise = self._noise(batches, device, eps, keeps, perms, seeds)
        tree = packed_from_model(self.model, self.layout)
        run = self._run
        whole_shapes = [tuple(t.shape) for t in _leaves(tree)]
        if run is not None:
            with modality_shard(run.shard):
                tree = run.local_tree(tree)
        params = [torch.nn.Parameter(t.detach().clone())
                  for t in _leaves(tree)]
        packed = _rebuild(tree, params)
        head = self._head()
        trained = params + ([] if head is None else list(head.parameters()))
        adam = MaskedAdam(trained, self.lr_fn)
        data_sum = row_reduce = None
        if run is None:
            def loss_fn(batch, eps_t):
                return self._loss(packed, batch, eps_t)
        else:
            run.set_leaves(trained, whole_shapes + [
                tuple(p.shape) for p in trained[len(params):]])
            if self.mesh.axis("data") > 1:
                data_sum = lambda t: self.mesh.all_reduce_(t, "data")
                row_reduce = lambda t: self.mesh.all_reduce_sum(t, "data")

            def loss_fn(batch, eps_t):
                with modality_shard(run.shard):
                    return self._loss(packed, batch, eps_t)

        def chunk(first_epoch, epochs):
            return run_epochs(loss_fn, trained, adam, batches, epochs,
                              self.log_keys, noise,
                              shuffle=self.config.shuffle,
                              state_update=self.state_update,
                              first_epoch=first_epoch, data_sum=data_sum,
                              row_reduce=row_reduce)

        session = TrainSession(chunk, adam, noise, self.log_keys,
                               dict(self.model.named_buffers()))
        session.packed = packed
        session.whole_packed = tree if run is None else _rebuild(
            tree, [torch.empty(s, device="meta") for s in whole_shapes])
        session.layout = run
        return session

    @torch.no_grad()
    def write_back(self, session: TrainSession) -> None:
        """The session's packed tree into the model (its head and buffers
        trained in place already)."""
        packed = session.packed
        if session.layout is not None:
            packed = session.layout.whole_tree(packed, session.whole_packed)
        tree = params_to_jax(self.model)
        tree.update(packed_to_jax(packed, self.layout))
        params_from_jax(tree, self.model)

    def run(self, stacked_batches, **draws) -> dict:
        """Train the model for ``config.epochs`` epochs; returns the logs
        {key: [F, epochs]} of the model's ``log_keys``."""
        with self.on_mesh(stacked_batches):
            session = self.session(stacked_batches, **draws)
            session.advance(self.config.epochs)
            self.write_back(session)
            logs = session.logs()
        return logs

    def run_milestones(self, stacked_batches, milestones: Sequence[int],
                       **draws):
        """Train to each milestone epoch (ascending) in turn, yielding
        ``(epoch, per-fold params in the JAX layout, logs)`` after each, as
        MultiFoldTrainer.run_milestones does."""
        with self.on_mesh(stacked_batches, template=True) as run:
            session = self.session(stacked_batches, **draws)
            folds = session.adam.count.shape[0]
            for m in milestones:
                if m < session.epoch:
                    raise ValueError(
                        f"milestones must ascend, got {milestones}")
                session.advance(m - session.epoch)
                self.write_back(session)
                params = (run.jax_params() if run is not None else
                          [params_to_jax(self.model, fold=f)
                           for f in range(folds)])
                yield m, params, session.logs()

    def run_resumable(self, stacked_batches, state_dir,
                      checkpoint_every: int, resume: bool = True,
                      **draws) -> dict:
        """``run`` in chunks of ``checkpoint_every`` epochs with one
        whole-run train state under ``state_dir`` (the packed parameters,
        Adam's moments and counts, the noise generators, the buffers, the
        epoch cursor); with ``resume`` a stored state is continued, and one
        written under another layout, loss or precision is refused."""
        with self.on_mesh(stacked_batches):
            session = self.session(stacked_batches, **draws)
            run_chunked(state_dir, self.config.epochs, checkpoint_every,
                        resume, session, self.loss_meta)
            self.resumed_from = session.start_epoch
            self.write_back(session)
            logs = session.logs()
        return logs
