"""Fold stacking and fold-parallel training (counterpart of
parallel/folds.py).

The JAX package vmaps one fold's program over fold-stacked params
(cli/common.py:643-661, parallel/folds.py:135). The port writes that batch
dimension out: every parameter of a model carries a leading fold axis, the
kernels take the fold as a grid axis, and ``MultiFoldTrainer`` trains every
fold in each step. ``stack_params`` builds a fold-stacked tree from per-fold
trees, e.g. the ones ``interop.read_flax_checkpoint`` returns.

On a mesh (parallel/mesh.py) each rank trains its part of the run: its
folds, its rows of every batch and, with a 'model' axis, its part of the
weights (``MeshRun``). The trainer splits the model in place at the start of
a run and gathers it whole again at the end, so the caller sees the
unmeshed run's model and logs on every rank; the train state is gathered
into the unmeshed layout on rank 0 and split again on resume.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..interop import params_to_jax
from ..train.checkpoints import run_chunked
from ..train.trainer import (
    DeviceBatches,
    MaskedAdam,
    StateUpdate,
    TrainConfig,
    TrainSession,
    build_lr_fn,
    fold_noise,
    make_batches,
    resolve_loss,
    run_epochs,
)
from .mesh import Mesh, ShardPlan, fold_data_shardings, shard_batches


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


def _cut(a, dim: int, lo: int, hi: int):
    """a[..., lo:hi, ...] along ``dim`` (numpy or torch)."""
    index = [slice(None)] * a.ndim
    index[dim] = slice(lo, hi)
    return a[tuple(index)]


class MeshRun:
    """One rank's part of a fold-stacked run on ``mesh`` by ``plan``
    (``ShardPlan``): folds [f0, f1) of every parameter, buffer and noise
    generator, rows [r0, r1) of every batch, and with ``plan.tensor`` the
    part of each weight parallel/tensor.py splits over 'model'. The model
    is split in place (``shard_``) and gathered whole again (``unshard_``);
    logs and train states are gathered into the unmeshed layout. The ranks
    along 'data' hold equal copies of everything but the batch rows: the
    gathers take the copy of data index 0."""

    def __init__(self, model, mesh: Mesh, plan: ShardPlan):
        self.model, self.mesh, self.plan = model, mesh, plan
        self.folds = next(model.parameters()).shape[0]
        self.shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        self.split: Dict[str, Optional[int]] = dict.fromkeys(self.shapes)
        if plan.tensor:
            from .tensor import tp_param_specs, tp_supported

            reason = tp_supported(model)
            if reason:
                raise ValueError(f"the 'model' mesh axis: {reason}")
            self.split = tp_param_specs(model, mesh.axis("model"))

    # -- slicing --------------------------------------------------------------
    def local(self, name: Optional[str], full):
        """This rank's part of a whole [F, ...] parameter (or buffer, with
        ``name`` None)."""
        f0, f1 = self.plan.folds
        part = full[f0:f1]
        dim = self.split.get(name) if name is not None else None
        if dim is not None:
            from .tensor import split_range

            part = _cut(part, dim, *split_range(part.shape[dim], self.mesh))
        return part

    def draws(self, draws: dict) -> dict:
        """Replayed draws and fold seeds cut to this rank's folds and rows:
        eps and keeps [steps, F, B, ...], perms [epochs, F, NB * B]."""
        f0, f1 = self.plan.folds
        r0, r1 = self.plan.rows
        out = dict(draws)
        if out.get("eps") is not None:
            out["eps"] = np.asarray(out["eps"])[:, f0:f1, r0:r1]
        if out.get("keeps") is not None:
            out["keeps"] = [np.asarray(k)[:, f0:f1, r0:r1]
                            for k in out["keeps"]]
        if out.get("perms") is not None:
            out["perms"] = np.asarray(out["perms"])[:, f0:f1]
        if out.get("seeds") is not None:
            out["seeds"] = list(out["seeds"])[f0:f1]
        return out

    @torch.no_grad()
    def shard_(self) -> None:
        if self.plan.tensor:
            from .tensor import attach_

            # the plans read the whole weights' shapes: before the split
            attach_(self.model, self.mesh)
        for name, p in self.model.named_parameters():
            p.data = self.local(name, p.data).clone()
        for _, b in self.model.named_buffers():
            b.data = self.local(None, b.data).clone()
        self._set_folds(self.plan.folds[1] - self.plan.folds[0])

    @torch.no_grad()
    def unshard_(self) -> None:
        params = self.gather_named(
            {n: p.detach().cpu().numpy()
             for n, p in self.model.named_parameters()})
        buffers = self.gather_named(
            {n: b.detach().cpu().numpy()
             for n, b in self.model.named_buffers()}, split=False)
        for name, p in self.model.named_parameters():
            p.data = torch.from_numpy(params[name]).to(p.device, p.dtype)
        for name, b in self.model.named_buffers():
            b.data = torch.from_numpy(buffers[name]).to(b.device, b.dtype)
        self._set_folds(self.folds)
        if self.plan.tensor:
            from .tensor import detach_

            detach_(self.model)

    def _set_folds(self, folds: int) -> None:
        if hasattr(self.model, "folds"):
            self.model.folds = folds

    # -- gathers (collective: every rank calls them in the same order) -------
    def _grid(self, obj) -> Dict[Tuple[int, int], object]:
        """{(fold index, model index): obj} of the ranks of data index 0."""
        return {(f, m): o for f, d, m, o in self.mesh.all_gather_object(
            (self.mesh.index("fold"), self.mesh.index("data"),
             self.mesh.index("model"), obj)) if d == 0}

    def _join(self, grid, get, dim: Optional[int]):
        """The whole array from the grid's parts: over 'model' along
        ``dim`` (None: the parts are equal), then over 'fold' along 0."""
        nm = self.mesh.axis("model")
        rows = []
        for f in range(self.mesh.axis("fold")):
            if dim is None:
                rows.append(get(grid[(f, 0)]))
            else:
                rows.append(np.concatenate([get(grid[(f, m)])
                                            for m in range(nm)], axis=dim))
        return np.concatenate(rows, axis=0)

    def gather_named(self, named: dict, split: bool = True) -> dict:
        """{name: whole array} from every rank's {name: part}."""
        grid = self._grid(named)
        return {name: self._join(grid, lambda o, n=name: o[n],
                                 self.split.get(name) if split else None)
                for name in named}

    def gather_logs(self, logs: dict) -> dict:
        grid = self._grid(logs)
        return {k: self._join(grid, lambda o, k=k: o[k], None) for k in logs}

    def local_logs(self, logs: dict) -> dict:
        f0, f1 = self.plan.folds
        return {k: np.asarray(v)[f0:f1] for k, v in logs.items()}

    def _flat_named(self, flat: np.ndarray, shapes: dict) -> dict:
        sizes = [int(np.prod(shape)) for shape in shapes.values()]
        return {name: part.reshape(shape) for (name, shape), part in zip(
            shapes.items(), np.split(flat, np.cumsum(sizes)[:-1]))}

    def gather_state(self, state: dict) -> Optional[dict]:
        """A rank's ``TrainSession.state()`` gathered into the unmeshed
        run's (rank 0), or None (the other ranks)."""
        local_shapes = {n: tuple(p.shape)
                        for n, p in self.model.named_parameters()}
        adam = state["adam"]
        part = {"adam": {k: self._flat_named(adam[k], local_shapes)
                         for k in ("flat", "m", "v")},
                "count": adam["count"], "noise": list(state["noise"]),
                "buffers": state["buffers"]}
        grid = self._grid(part)
        if not self.mesh.primary:
            return None

        def flat(key):
            return np.concatenate([
                self._join(grid, lambda o, n=name: o["adam"][key][n],
                           self.split[name]).reshape(-1)
                for name in self.shapes])

        noise = []
        for f in range(self.mesh.axis("fold")):
            noise += grid[(f, 0)]["noise"]
        return {"adam": {"flat": flat("flat"), "m": flat("m"),
                         "v": flat("v"),
                         "count": self._join(grid, lambda o: o["count"],
                                             None)},
                "noise": noise,
                "buffers": {k: self._join(grid, lambda o, k=k: o["buffers"][k],
                                          None)
                            for k in state["buffers"]}}

    def local_state(self, tensors: dict) -> dict:
        """This rank's part of a stored (unmeshed) train state."""
        f0, f1 = self.plan.folds
        adam = tensors["adam"]

        def flat(key):
            named = self._flat_named(np.asarray(adam[key]), self.shapes)
            return np.concatenate([self.local(n, a).reshape(-1)
                                   for n, a in named.items()])

        return {"adam": {"flat": flat("flat"), "m": flat("m"),
                         "v": flat("v"),
                         "count": np.asarray(adam["count"])[f0:f1]},
                "noise": list(tensors.get("noise") or [])[f0:f1],
                "buffers": {k: np.asarray(v)[f0:f1] for k, v in
                            (tensors.get("buffers") or {}).items()}}

    def jax_params(self) -> List[dict]:
        """Every fold's parameters in the JAX layout (a snapshot of the
        split model, gathered; ``run_milestones``)."""
        whole = self.gather_named({n: p.detach().cpu().numpy()
                                   for n, p in self.model.named_parameters()})
        template = self.template
        with torch.no_grad():
            for name, p in template.named_parameters():
                p.data = torch.from_numpy(whole[name])
        return [params_to_jax(template, fold=f) for f in range(self.folds)]


class MultiFoldTrainer:
    """Trains every fold of a fold-stacked model at once: the port's only
    plain trainer. The JAX package's per-fold path and its --fold_parallel
    path follow the same trajectory (train/trainer.py:317-323), so both map
    onto this one. With ``config.shuffle`` each fold's rows are permuted
    every epoch over its own batch grid, the JAX package's sequential
    per-fold numerics (its fold-parallel path falls back to them when fold
    grids differ, cli/common.py:888-896). ``state_update(aux, valid)``
    applies non-gradient state after each step (the end-to-end model's
    BatchNorm running statistics, ``EndToEndCVAE.update_state``). With
    ``config.precision="bf16"`` or ``config.remat`` the default loss runs
    its forward in bf16 or recomputes it in the backward
    (``train.trainer.default_loss_fn``).

    ``run``, ``run_milestones`` and ``run_resumable`` advance one
    ``TrainSession``: a run in chunks (milestones, checkpoints) is the
    uninterrupted run, bit for bit. An eager loop compiles nothing, so the
    JAX package's compile-reuse policy for chunk sizes has no counterpart.

    With ``mesh`` every rank of the mesh runs this trainer on the same
    arguments (parallel/folds.py:135-160): ``shardings_fn(mesh, folds,
    batch rows)`` plans what a rank holds (``mesh.fold_data_shardings`` by
    default, ``tensor.fold_model_shardings`` for the 'model' axis), and the
    run is the unmeshed run up to the order of the partial sums.
    """

    def __init__(self, model, config: TrainConfig, n_samples: int,
                 loss_fn: Optional[Callable] = None,
                 state_update: Optional[StateUpdate] = None,
                 mesh: Optional[Mesh] = None,
                 shardings_fn: Optional[Callable] = None):
        if mesh is not None and mesh.axis("data") > 1 and config.shuffle:
            raise ValueError("the per-epoch shuffle permutes rows across "
                             "the 'data' mesh axis's shards: train it "
                             "without a data axis")
        self.model = model
        self.config = config
        self.mesh = mesh
        self.shardings_fn = shardings_fn or fold_data_shardings
        self.lr_fn = build_lr_fn(config, n_samples)
        self.loss_fn, self.loss_meta = resolve_loss(model, config, loss_fn)
        self.state_update = state_update
        self.resumed_from = 0   # the epoch run_resumable took the run up at
        self._run: Optional[MeshRun] = None   # while split over the mesh

    @contextlib.contextmanager
    def on_mesh(self, stacked_batches, template: bool = False):
        """The model split over the mesh for the duration (nothing without
        one), gathered whole at the end; ``template`` keeps a CPU copy of
        the whole model for snapshots."""
        if self.mesh is None:
            yield None
            return
        if not isinstance(stacked_batches, dict):
            raise ValueError("a run on a mesh takes stack_fold_batches "
                             "output, not batches already on the device")
        folds = next(self.model.parameters()).shape[0]
        rows = np.asarray(stacked_batches["mask"]).shape[2]
        run = self._mesh_run(self.shardings_fn(self.mesh, folds, rows))
        if template:
            # a CPU copy of the whole model, for run.jax_params
            run.template = copy.deepcopy(self.model).cpu()
        run.shard_()
        self._run = run
        yield run
        # not reached when the run raised: the other ranks may not gather
        self._run = None
        run.unshard_()

    def _mesh_run(self, plan) -> MeshRun:
        """This rank's part of the run by ``plan``."""
        return MeshRun(self.model, self.mesh, plan)

    def local_batches(self, stacked_batches: dict) -> dict:
        """This rank's part of ``stack_fold_batches`` output (all of it
        off a mesh)."""
        if self._run is None:
            return stacked_batches
        return shard_batches(stacked_batches, self._run.plan)

    def _data_sums(self):
        """(the in-place sum over the 'data' axis, its differentiable
        sum), or Nones without the axis."""
        if self._run is None or self.mesh.axis("data") <= 1:
            return None, None
        return (lambda t: self.mesh.all_reduce_(t, "data"),
                lambda t: self.mesh.all_reduce_sum(t, "data"))

    def session(self, stacked_batches, eps=None, keeps=None,
                perms=None, seeds=None, noise=None) -> TrainSession:
        """A new run of ``self.model`` (trained in place) over
        ``stack_fold_batches`` output (or those batches already on the
        device: ``DeviceBatches``, or a streamed view of them). By default
        each fold draws its own noise, keep masks (a model with
        ``keep_widths``) and permutations from a generator seeded ``config.seed``, or ``seeds[f]`` for fold f when
        ``seeds`` is given (``FoldNoise``). Tests replay given draws
        instead: ``eps`` [epochs * NB, F, B, Z] (Z is the model's
        ``noise_dim``), ``keeps`` one [epochs * NB, F, B, width] per keep
        width, ``perms`` [epochs, F, NB * B] when shuffling. ``noise``, a
        ``FoldNoise`` or ``ReplayNoise`` built by the caller
        (``train.trainer.FoldTrainer``), takes the place of all of these.
        The batches and the replayed noise take the parameters' dtype."""
        params = list(self.model.parameters())
        device, dtype = params[0].device, params[0].dtype
        batches = stacked_batches
        if isinstance(batches, dict):
            batches = DeviceBatches(self.local_batches(stacked_batches),
                                    device, dtype)
        if noise is not None and self._run is not None:
            raise ValueError("a run on a mesh draws its own noise: pass "
                             "eps/keeps/perms/seeds, not a noise source")
        if self._run is not None:
            draws = self._run.draws(dict(eps=eps, keeps=keeps, perms=perms,
                                         seeds=seeds))
            eps, keeps, perms, seeds = (draws[k] for k in
                                        ("eps", "keeps", "perms", "seeds"))
        if noise is None:
            noise = fold_noise(self.model, self.config, batches, device,
                               dtype, eps, keeps, perms, seeds)
        adam = MaskedAdam(params, self.lr_fn)
        log_keys = self.model.log_keys
        data_sum, row_reduce = self._data_sums()

        def chunk(first_epoch, epochs):
            return run_epochs(self.loss_fn, params, adam, batches, epochs,
                              log_keys, noise, shuffle=self.config.shuffle,
                              state_update=self.state_update,
                              first_epoch=first_epoch, data_sum=data_sum,
                              row_reduce=row_reduce)

        session = TrainSession(chunk, adam, noise, log_keys,
                               dict(self.model.named_buffers()))
        session.layout = self._run
        return session

    def run(self, stacked_batches, **draws) -> dict:
        """Train ``self.model`` in place for ``config.epochs`` epochs (the
        arguments are ``session``'s). Returns the logs {key: [F, epochs]
        numpy} for every key of the model's ``log_keys``."""
        with self.on_mesh(stacked_batches):
            session = self.session(stacked_batches, **draws)
            session.advance(self.config.epochs)
            logs = session.logs()
        return logs

    def run_milestones(self, stacked_batches, milestones: Sequence[int],
                       **draws):
        """Train to each milestone epoch (ascending) in turn, yielding
        ``(epoch, per-fold params in the JAX layout, logs)`` after each
        (parallel/folds.py:245-269): one run to max(milestones) serves every
        epoch count of a grid, each snapshot equal to the run of that many
        epochs. The model trains in place; a snapshot is a copy."""
        with self.on_mesh(stacked_batches, template=True) as run:
            session = self.session(stacked_batches, **draws)
            folds = session.adam.count.shape[0]
            for m in milestones:
                if m < session.epoch:
                    raise ValueError(
                        f"milestones must ascend, got {milestones}")
                session.advance(m - session.epoch)
                params = (run.jax_params() if run is not None else
                          [params_to_jax(self.model, fold=f)
                           for f in range(folds)])
                yield m, params, session.logs()

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
        meta = dict(self.loss_meta)
        if draws.get("seeds") is not None:
            meta["fold_seeds"] = ",".join(str(int(s)) for s in draws["seeds"])
        if self.mesh is not None:
            # a meshed run's partial sums come in another order: its state
            # continues only under the same geometry
            meta["mesh"] = ",".join(f"{k}={v}"
                                    for k, v in self.mesh.shape.items())
        with self.on_mesh(stacked_batches):
            session = self.session(stacked_batches, **draws)
            run_chunked(state_dir, self.config.epochs, checkpoint_every,
                        resume, session, meta)
            self.resumed_from = session.start_epoch
            logs = session.logs()
        return logs
