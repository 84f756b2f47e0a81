"""Supervised multimodal cVAE k-fold training (counterpart of
cli/train_supervised.py).

The same flags and files as the JAX CLI: the k-fold id CSVs, per fold
``NNN/cVAE_model.{ckpt,json}`` (the flax msgpack format, which the JAX and
the port's test stages both read) and ``NNN/Lossestraining.png`` (needs
matplotlib), and ``run_log.jsonl``. Every fold trains at once on one
fold-stacked model (``parallel.MultiFoldTrainer``); the JAX package's
per-fold path and its ``--fold_parallel`` path follow the same trajectory,
so both map onto it. ``--fused_decoder`` runs each modality's mean head and
Gaussian NLL through the ``decoder_nll`` CUDA kernel pair.
``--fused_train_step`` trains every fold at once on the fused train step
(``train.fused.FusedFoldTrainer``: K5 in fp32, K6 with ``--precision
bf16``); where the JAX CLI falls back to its XLA path for a configuration
the fused step does not take, this one exits and says why. ``-Model`` takes
the six registry names (cVAE_multimodal, mmJSD, mvtCAE, DMVAE,
WeightedDMVAE, mmVAEPlus); both fused paths compute cVAE_multimodal's loss
and exit for the other five. ``--checkpoint_every N`` saves a whole-run
train state every N epochs (``train_state.ckpt`` in the model dir; the
fused train step's under ``fused-state/``) and ``--resume`` continues it:
the resumed run's checkpoints equal the uninterrupted run's, byte for byte.
``--packed_xla`` trains every fold at once on a packed-modality layout
(``train.grouped.select_packed_trainer``: width-grouped for a mixed-width
cvae-skeleton cohort, padded for uniform widths, split-latent for the DMVAE
family; its train state under that layout's own directory, e.g.
``grouped-state/``), in fp32 or, for cVAE_multimodal, ``--precision bf16``;
where the JAX CLI does not take the packed layout it says why and trains
the per-modality layout, as the JAX CLI does. ``--in_memory_fusion`` builds
a UCA procedure's early-fusion modality from the scaled base modalities
(``common.fuse_preps``) instead of reading its CSV, on every path.
``--stream_shards S`` trains the per-modality layout out of core
(``train.streaming.StreamingFoldTrainer``: the batches in S shards, one
uploading while the one before it computes; -1 sizes S from the card's
memory); its checkpoints and train state are the resident run's, byte for
byte. ``--precision bf16`` without ``--packed_xla`` or
``--fused_train_step`` runs the per-modality forward in bfloat16 (fp32
master weights), ``--remat`` recomputes it in the backward, and
``--profile_dir DIR`` writes a torch.profiler trace of the run.
``--fold_parallel --mesh F,D[,M]`` trains on a mesh of ranks, one process
each (``python -m torch.distributed.run --nproc_per_node F*D*M``): folds
over F, batch rows over D, the weights tensor-parallel over M
(``parallel.MultiFoldTrainer(mesh=)``); ``--stream_shards S --mesh 1,D``
streams each rank's rows. Rank 0 writes every file, in the unmeshed
format; ``--fused_train_step``/``--packed_xla`` are ignored with a mesh, as
in the JAX CLI, and ``--fused_decoder`` exits.

    python -m multi_modal_normative_modeling_tpu_torch.cli.train_supervised \\
        -R ADNI -P UCA-gPoE -E 200 -K 5 [--fused_decoder] [--device cpu]
        [--fused_train_step [--precision bf16]] [-Model mvtCAE]
        [--checkpoint_every N [--resume]] [--in_memory_fusion]
        [--packed_xla [--precision bf16]] [--stream_shards S]
        [--precision bf16] [--remat] [--profile_dir DIR]
        [--fold_parallel --mesh F,D[,M]]
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import numpy as np
import pandas as pd
import torch

from .. import registry
from ..interop import packed_from_model, packed_to_model, params_to_jax
from ..kernels.decoder_nll import fused_decoder_loss_fn
from ..models import REGISTRY, build_model
from ..parallel import MultiFoldTrainer, stack_fold_batches
from ..train import TrainConfig
from ..train.fused import FusedFoldTrainer, supported
from ..train.grouped import select_packed_trainer
from ..train.packed import packed_supported
from ..train.streaming import StreamingFoldTrainer, shard_plan
from ..utils.logging import RunLog
from . import common

# JAX CLI flags with no port: each raises instead of being ignored
_NOT_PORTED_FLAGS = {
    'warmup_only': "'Do not port' (a TPU compile-cache warm-up)",
}
EP_USAGE = '4,2 (modality,data) or 2,2,2 (fold,modality,data)'

EpsFn = Callable[[np.ndarray, int, int, int], np.ndarray]


def default_init(model, name: str = 'cVAE_multimodal') -> None:
    """Every fold starts from the same weights, as the reference re-seeds 42
    per fold (train:119): one fold of the registry model ``name`` drawn from
    torch.Generator seeded 42, repeated over the model's folds."""
    common.init_from_one_fold(model, build_model(
        name, model.input_dim_list, model.hidden_dim, model.latent_dim,
        model.c_dim, model.modalities, getattr(model, 'non_linear', True),
        folds=1, generator=torch.Generator().manual_seed(42)))


def main(args, project_root=None, init_fn: Optional[common.InitFn] = None,
         eps_fn: Optional[EpsFn] = None):
    """``init_fn(model)`` fills the fold-stacked model's initial weights
    (default: ``default_init``). ``eps_fn(valid [F, NB], epochs, batch rows,
    latent dim)`` gives the noise of every step, [epochs * NB, F, rows, Z]
    (tests replay the JAX package's draws; the latent dim is the model's
    ``noise_dim``, the shared code's width for the DMVAE family); by default
    every fold draws from its own generator on the device."""
    common.refuse_not_ported(args, 'trainer', _NOT_PORTED_FLAGS)
    if getattr(args, 'mesh', None) and not getattr(args, 'fold_parallel',
                                                   False) \
            and not getattr(args, 'stream_shards', 0):
        raise SystemExit('--mesh requires --fold_parallel (the mesh shards '
                         'the stacked fold-parallel program) — except with '
                         '--stream_shards, where --mesh 1,D shards each '
                         'streamed shard\'s rows over the data axis')
    common.require_checkpoint_for_resume(args)
    ep_spec = getattr(args, 'ep_mesh', None)
    if ep_spec:
        ep_sizes = common.parse_axis_sizes(ep_spec, '--ep_mesh', (2, 3),
                                           EP_USAGE)
        _ep_flag_conflicts(args, ep_sizes)
    elif getattr(args, 'mesh', None):
        _mesh_flag_conflicts(args)
    fused = getattr(args, 'fused_train_step', False)
    # the fused train step takes precedence over --packed_xla, as in JAX
    packed_flag = getattr(args, 'packed_xla', False) and not fused
    precision = getattr(args, 'precision', 'fp32')
    if fused:
        unsupported = _fused_flag_conflict(args)
        if unsupported:
            raise SystemExit(f'fused train step unavailable ({unsupported})')
    elif getattr(args, 'fused_decoder', False) and not packed_flag:
        unsupported = (_cvae_only(args, 'the decoder_nll kernel pair')
                       or _fp32_only(precision))
        if unsupported:
            raise SystemExit(f'fused decoder unavailable ({unsupported})')
    remat = getattr(args, 'remat', False)
    if remat and (fused or getattr(args, 'packed_xla', False) or ep_spec):
        print('--remat applies to the standard XLA loss; ignoring it for '
              '--fused_train_step/--packed_xla/--ep_mesh')
    device = common.resolve_device(getattr(args, 'device', 'cuda'), 'train')
    batch_size = getattr(args, 'batch_size', None)
    batch_size = 256 if batch_size is None else int(batch_size)
    if batch_size < 1:
        raise SystemExit(f'--batch_size must be >= 1, got {batch_size}')
    mesh, mesh_shardings = common.parse_mesh(
        getattr(args, 'mesh', None), args.n_splits, batch_size, device)
    if mesh is not None:
        device = mesh.device
        common.announce_mesh(mesh, 'fold-parallel training')
    ep_mesh, _ = common.parse_ep_mesh(ep_spec, (2, 3), EP_USAGE, device)
    if ep_mesh is not None:
        device = ep_mesh.device
        common.announce_mesh(ep_mesh, 'expert-parallel training')
        # rank 0 writes every file, as on --mesh
        mesh = ep_mesh
    primary = mesh is None or mesh.primary

    project_root = Path(project_root) if project_root else Path.cwd()
    model_name = 'supervised_cvae'
    kfold_dir = project_root / 'outputs' / 'kfold_analysis'
    model_dir = kfold_dir / model_name
    model_dir.mkdir(parents=True, exist_ok=True)

    np.random.seed(42)

    dataset_names = registry.get_datasets_name(args.dataset_resourse,
                                               args.procedure)
    participants_path = project_root / 'data' / args.dataset_resourse / 'y.csv'
    ids_df = pd.read_csv(participants_path)
    hc_label = registry.get_hc_label(args.dataset_resourse)
    training_class_label = hc_label if args.training_class == 'nm' else 0
    if primary:
        common.generate_kfold_ids(
            ids_df[ids_df['DIA'] == training_class_label],
            ids_df[ids_df['DIA'] != training_class_label],
            oversample_percentage=args.oversample_percentage,
            n_splits=args.n_splits, project_root=project_root)
        run_log = RunLog(model_dir / 'run_log.jsonl')
        run_log.event('train_start', args=vars(args))
    if mesh is not None:
        # the other ranks read the id files rank 0 wrote
        mesh.barrier()

    n_folds = args.n_splits
    folds, input_dim_list, c_dim = common.prepare_folds(
        args, project_root, kfold_dir, model_dir, dataset_names,
        participants_path)
    config_dict = common.model_config_dict(args, input_dim_list, c_dim,
                                           len(dataset_names))
    train_config = TrainConfig(
        epochs=args.epochs,
        batch_size=batch_size,
        learning_rate=0.0001,
        combine=args.combine,
        lr_schedule=getattr(args, 'lr_schedule', 'constant'),
        base_lr=args.base_learning_rate,
        max_lr=args.max_learning_rate,
        seed=42,
        precision=precision,
        remat=remat,
    )

    model = common.build_model_from_config(config_dict, folds=n_folds)
    ep = None
    if ep_mesh is not None:
        ep = _ep_trainer(args, ep_sizes, ep_mesh, model, train_config, folds,
                         model_dir)
    elif mesh is not None:
        unsupported = _mesh_model_conflict(model, mesh)
        if unsupported:
            raise SystemExit(f'--mesh {args.mesh}: {unsupported}')
    if fused:
        ok, reason = supported(model, train_config)
        if ok:
            reason = common.uniform_covariates(folds)
            ok = reason is None
        if not ok:
            raise SystemExit(f'fused train step unavailable ({reason})')
    packed = None
    if packed_flag:
        ok, reason = packed_supported(model, train_config)
        if ok:
            reason = common.uniform_covariates(folds)
            ok = reason is None
        if ok:
            packed = select_packed_trainer(model)
        else:
            print(f'packed XLA path unavailable ({reason}); '
                  'using the per-modality path')
    fused_decoder = getattr(args, 'fused_decoder', False)
    if packed is not None and fused_decoder:
        print('fused decoder unavailable (mutually exclusive with '
              '--packed_xla); using the plain loss')
        fused_decoder = False
    elif fused_decoder and packed_flag:
        # checked here: the packed layout was not taken after all
        unsupported = (_cvae_only(args, 'the decoder_nll kernel pair')
                       or _fp32_only(precision))
        if unsupported:
            raise SystemExit(f'fused decoder unavailable ({unsupported})')
    stream_shards = _stream_shards(args, folds, device,
                                   packed is not None, fused, mesh)
    if init_fn is not None:
        init_fn(model)
    else:
        default_init(model, config_dict['model'])
    model.to(device)
    max_n = max(f[0][0].shape[0] for f in folds)
    resumable = common.Resumable(args)
    if fused:
        # its own state dir: the padded packed layout
        logs, steps, run_s = _train_fused(model, train_config, folds, max_n,
                                          device, eps_fn, resumable,
                                          model_dir / 'fused-state')
    else:
        # the whole-run state in the model dir, as the JAX CLI's
        # fold-parallel path keeps it; a packed layout's in its own dir
        logs, steps, run_s = _train(fused_decoder, model, train_config,
                                    folds, max_n, eps_fn, resumable,
                                    model_dir, packed, stream_shards,
                                    None if ep else mesh, mesh_shardings,
                                    ep)
    per_fold_logs = [{k: v[f] for k, v in logs.items()}
                     for f in range(n_folds)]
    if not primary:
        # rank 0 writes every file; the run ends when it has
        mesh.barrier()
        return
    per_fold_params = [params_to_jax(model, fold=f) for f in range(n_folds)]
    common.emit_fold_artifacts(model_dir, per_fold_logs, per_fold_params,
                               config_dict, n_folds)
    # fold_done only after the fold's artifacts are on disk
    for fold in range(n_folds):
        last = {k: float(v[-1]) for k, v in per_fold_logs[fold].items()}
        print('Train fold:', fold, ' final-epoch ',
              ', '.join(f'{k}: {round(v, 3)}' for k, v in last.items()))
        run_log.event('fold_done', fold=fold, **last)
        print('fold_model_dir:', model_dir / f'{fold:03d}')
    # the trainer's run alone: batches to the device, every step this call
    # ran (a resumed run's from its stored epoch), the logs' fetch at the end
    run_log.event('train_end', folds=n_folds, steps=steps, run_s=run_s,
                  **resumable.fields())
    if mesh is not None:
        mesh.barrier()


def _mesh_flag_conflicts(args) -> None:
    """--mesh's flags (JAX cli/train_supervised.py:149-153, :272-289): the
    mesh runs on the standard fold-parallel path, so --fused_train_step
    and --packed_xla are ignored, as in the JAX CLI; --fused_decoder, where
    the JAX CLI falls back to its plain loss, exits here."""
    if (getattr(args, 'fused_train_step', False)
            or getattr(args, 'packed_xla', False)):
        print('--mesh runs on the standard fold-parallel path; ignoring '
              '--fused_train_step/--packed_xla')
        args.fused_train_step = False
        args.packed_xla = False
    if getattr(args, 'fused_decoder', False):
        raise SystemExit('fused decoder unavailable (mutually exclusive with '
                         '--mesh): the JAX package trains the plain loss '
                         'here, this CLI exits instead (ROADMAP.md, "Stated '
                         'divergences"). Train without --fused_decoder')


def _ep_flag_conflicts(args, sizes) -> None:
    """--ep_mesh's conflicts (JAX cli/train_supervised.py:192-198), and
    --fused_decoder, where the JAX CLI falls back to its plain loss, exits
    here as on --mesh."""
    conflicts = [name for name, on in [
        ('--mesh', bool(getattr(args, 'mesh', None))),
        ('--fold_parallel', getattr(args, 'fold_parallel', False)
         and len(sizes) == 2),
        ('--packed_xla', getattr(args, 'packed_xla', False)),
        ('--fused_train_step', getattr(args, 'fused_train_step', False)),
    ] if on]
    if conflicts:
        raise SystemExit('--ep_mesh is mutually exclusive with '
                         + ', '.join(conflicts))
    if getattr(args, 'fused_decoder', False):
        raise SystemExit('fused decoder unavailable (mutually exclusive with '
                         '--ep_mesh): the JAX package trains the plain loss '
                         'here, this CLI exits instead (ROADMAP.md, "Stated '
                         'divergences"). Train without --fused_decoder')
    if getattr(args, 'stream_shards', 0):
        raise SystemExit('--stream_shards is mutually exclusive with '
                         '--ep_mesh (out-of-core streaming is a sequential '
                         'whole-fold path)')


class EPRun(NamedTuple):
    """An --ep_mesh run: its trainer, its train-state dir and what the CLI
    prints."""
    trainer: object
    state_dir: Path
    say: str


def _ep_trainer(args, sizes, mesh, model, train_config, folds,
                model_dir: Path) -> EPRun:
    """The --ep_mesh trainer after the JAX CLI's gates, in its order and
    words (cli/train_supervised.py:199-254): the packed layout's scope, one
    covariate block, the divisibility of every axis, the cvae skeleton.
    M,D trains on ``parallel.modality.EPFoldTrainer``; F,M,D on the packed
    trainer of the layout ``--packed_xla`` would take (width-grouped for
    mixed widths, else padded) with its plan."""
    from ..parallel.modality import (
        EPFoldTrainer,
        grouped_fold_shardings,
        packed_fold_shardings,
    )
    from ..train.grouped import GroupedMultiFoldTrainer, grouped_routing
    from ..train.packed import PackedMultiFoldTrainer

    ok, reason = packed_supported(model, train_config)
    if ok:
        reason = common.uniform_covariates(folds)
        ok = reason is None
    if not ok:
        raise SystemExit(f'--ep_mesh unavailable ({reason})')
    indivisible = common.ep_mesh_divisibility(
        sizes, len(folds), train_config.batch_size, model.modalities)
    if indivisible:
        raise SystemExit(f'--ep_mesh {args.ep_mesh}: {indivisible}')
    if getattr(model, 'variant', None) not in ('cvae', 'mmjsd', 'mvtcae',
                                               'nmmlp'):
        raise SystemExit('--ep_mesh supports the cvae skeleton only '
                         '(cvae/mmjsd/mvtcae/nmmlp)')
    if mesh.axis('data') > 1 and getattr(model, 'variant', None) == 'mvtcae':
        raise SystemExit(f'--ep_mesh {args.ep_mesh}: '
                         + _mesh_model_conflict(model, mesh))
    max_n = max(f[0][0].shape[0] for f in folds)
    axes = dict(mesh.shape)
    try:
        if len(sizes) == 3:
            if grouped_routing(model):
                trainer = GroupedMultiFoldTrainer(
                    model, train_config, max_n, mesh=mesh,
                    shardings_fn=grouped_fold_shardings)
                return EPRun(trainer, model_dir / 'ep-grouped-state',
                             'train model (all folds fold-parallel, '
                             'expert-parallel width-grouped modalities, '
                             f'mesh {axes})')
            trainer = PackedMultiFoldTrainer(
                model, train_config, max_n, mesh=mesh,
                shardings_fn=packed_fold_shardings)
            return EPRun(trainer, model_dir / 'ep-packed-state',
                         'train model (all folds fold-parallel, '
                         f'expert-parallel modalities, mesh {axes})')
        trainer = EPFoldTrainer(model, train_config, max_n, mesh)
    except ValueError as exc:
        raise SystemExit(f'--ep_mesh {args.ep_mesh}: {exc}')
    return EPRun(trainer, model_dir / 'ep-state',
                 f'train model (expert-parallel modalities, mesh {axes})')


def _mesh_model_conflict(model, mesh) -> Optional[str]:
    """Why ``model`` cannot train on ``mesh``, or None: mvtCAE's total
    correlation is a log-sum-exp over a batch's rows, not a sum of row
    terms, so it does not split over 'data'; the 'model' axis splits the
    cVAE skeleton's encoders and decoders only."""
    if mesh.axis('data') > 1 and getattr(model, 'variant', None) == 'mvtcae':
        return ("model 'mvtCAE': its total correlation (a log-sum-exp over "
                "the batch's rows) does not split over the 'data' axis; "
                'train it with a data axis of 1')
    if mesh.axis('model') > 1:
        from ..parallel.tensor import tp_supported

        return tp_supported(model)
    return None


def _fp32_only(precision: str) -> Optional[str]:
    """Why the decoder_nll kernel pair cannot train at ``precision``, or
    None: K4 takes fp32 only."""
    if precision == 'fp32':
        return None
    return ('cvae variant, fp32 only: the decoder_nll kernel pair takes '
            f'fp32 operands; the JAX package trains --precision {precision} '
            'on its plain loss here, this CLI exits instead (ROADMAP.md, '
            '"Stated divergences"). Train without --fused_decoder')


def _stream_shards(args, folds, device, packed: bool, fused: bool,
                   mesh=None) -> int:
    """--stream_shards resolved (JAX cli/train_supervised.py:301-311,
    :533-558): 0 trains resident, -1 sizes the shard count so that two
    shards of fold 0's batch data fit in half the device's memory. Exits on
    the JAX CLI's conflicts, on a mesh with another axis than 'data' wider
    than 1, and on a value below -1."""
    shards = getattr(args, 'stream_shards', 0) or 0
    if not shards:
        return 0
    if mesh is not None:
        # --mesh 1,D composes: rows of each streamed shard over 'data'
        bad = [n for n in mesh.axis_names
               if n != 'data' and mesh.shape[n] != 1]
        if bad:
            raise SystemExit(
                f'--stream_shards composes only with --mesh 1,D '
                f'(data-axis sharding); axis {bad[0]!r} has size '
                f'{mesh.shape[bad[0]]} — use --fold_parallel --mesh '
                'for fold/tensor parallelism')
    conflicts = [name for name, on in [
        ('--fold_parallel', getattr(args, 'fold_parallel', False)),
        ('--packed_xla', packed),
        ('--fused_train_step', fused),
    ] if on]
    if conflicts:
        raise SystemExit('--stream_shards is mutually exclusive with '
                         + ', '.join(conflicts)
                         + ' (out-of-core streaming is a sequential '
                           'whole-fold path)')
    if shards == -1:
        hbm = (torch.cuda.mem_get_info(device)[1] if device.type == 'cuda'
               else 16 * 2**30)
        budget = hbm // 2
        total = sum(int(np.asarray(a).nbytes)
                    for a in list(folds[0][0]) + list(folds[0][1]))
        shards = shard_plan(total, budget)
        print(f'--stream_shards auto: {total / 2**20:.0f} MiB '
              f'batch data vs {budget / 2**20:.0f} MiB budget '
              f'-> {shards} shard(s)')
    elif shards < 1:
        raise SystemExit(f'--stream_shards must be >= 1 (or -1 for auto), '
                         f'got {shards}')
    return shards


def _cvae_only(args, what: str) -> Optional[str]:
    """Why a path that computes cVAE_multimodal's loss cannot train
    ``args.model``, or None."""
    name = getattr(args, 'model', 'cVAE_multimodal')
    if name == 'cVAE_multimodal' or name not in REGISTRY:
        return None  # an unknown name is build_model's to refuse
    return (f'model {name!r}: {what} computes the cVAE_multimodal loss '
            'only, as in the JAX package, which falls back to its plain '
            'loss here; this CLI exits instead (ROADMAP.md, "Stated '
            'divergences"). Train this model without the flag')


def _fused_flag_conflict(args) -> Optional[str]:
    """Why --fused_train_step cannot run with these flags (checked before
    any file is written), or None."""
    unsupported = _cvae_only(args, 'the fused train step')
    if unsupported:
        return unsupported
    combine = (getattr(args, 'combine', None)
               or getattr(args, 'procedure', 'UCA-gPoE').split('-')[1])
    if combine.lower() not in ('poe', 'gpoe', 'moe', 'mopoe'):
        return f'fusion {combine!r}'
    if getattr(args, 'fused_decoder', False):
        return ('--fused_decoder is mutually exclusive with '
                '--fused_train_step')
    return None


def _train_fused(model, train_config, folds, max_n, device, eps_fn,
                 resumable: common.Resumable, state_dir: Path):
    """Every fold at once on the fused train step; the trained parameters
    go back into ``model``. Returns (logs, steps this call ran, seconds of
    the run)."""
    trainer = FusedFoldTrainer(model, train_config, max_n)
    # one covariate block for every modality (uniform_covariates checked)
    batches = trainer.batches([f[0] for f in folds], [f[1][0] for f in folds],
                              device)
    eps = None
    if eps_fn is not None:
        eps = eps_fn(batches.valid_host.T, train_config.epochs,
                     train_config.batch_size, model.noise_dim)
    kernel = 'K6, bf16' if train_config.precision == 'bf16' else 'K5'
    print(f'train model (all folds fold-parallel, fused train-step CUDA '
          f'kernel {kernel})')
    packed = packed_from_model(model, trainer.stacked)
    start = time.perf_counter()
    trained, logs = resumable.run(trainer, packed, batches, eps=eps,
                                  state_dir=state_dir)
    run_s = time.perf_counter() - start
    packed_to_model(trained, trainer.stacked, model)
    epochs = train_config.epochs - resumable.resumed_from
    return logs, epochs * batches.n_batches, run_s


def _train(fused_decoder: bool, model, train_config, folds, max_n, eps_fn,
           resumable: common.Resumable, state_dir: Path, packed=None,
           stream_shards: int = 0, mesh=None, shardings_fn=None,
           ep: Optional[EPRun] = None):
    """Every fold at once on MultiFoldTrainer (plain or --fused_decoder
    loss; streamed in ``stream_shards`` shards when that is not 0), on
    the layout of ``packed`` (select_packed_trainer's choice), or on the
    --ep_mesh trainer ``ep``; trains ``model`` in place. The streamed run keeps its train state where the
    resident run does: either resumes the other's. Returns (logs, steps
    this call ran, seconds of the run)."""
    batch_size = train_config.batch_size
    loss_fn = None
    if fused_decoder:
        if train_config.remat:
            print('--remat applies to the standard XLA loss; ignoring it '
                  'for --fused_decoder')
        loss_fn = fused_decoder_loss_fn(model, train_config)
        print('train model (fused decoder+NLL CUDA kernel pair)')
    if stream_shards:
        try:
            trainer = StreamingFoldTrainer(model, train_config, max_n,
                                           shards=stream_shards,
                                           loss_fn=loss_fn, mesh=mesh)
        except ValueError as exc:
            raise SystemExit(f'--stream_shards: {exc}')
        _say(mesh, f'train model (streamed, {stream_shards} batch shards'
             + ('' if mesh is None else f', rows over mesh {mesh.shape}')
             + ')')
    elif ep is not None:
        trainer, state_dir = ep.trainer, ep.state_dir
        if ep.state_dir.name == 'ep-grouped-state' and resumable.every \
                and resumable.resume:
            from ..train.grouped import notice_stale_padded_state

            notice_stale_padded_state(state_dir.parent, 'grouped',
                                      stale_dirname='ep-packed-state',
                                      new_dirname='ep-grouped-state')
        mesh = trainer.mesh
    elif packed is None:
        trainer = MultiFoldTrainer(model, train_config, max_n,
                                   loss_fn=loss_fn, mesh=mesh,
                                   shardings_fn=shardings_fn)
    else:
        cls, layout, tag = packed
        trainer = cls(model, train_config, max_n)
        state_dir = common.packed_state_dir(state_dir, tag, resumable)
    batches = stack_fold_batches([f[0] for f in folds], [f[1] for f in folds],
                                 batch_size)
    eps = None
    if eps_fn is not None:
        eps = eps_fn(batches['valid'], train_config.epochs, batch_size,
                     model.noise_dim)
    if ep is not None:
        _say(mesh, ep.say)
    elif not stream_shards:
        _say(mesh, 'train model (all folds fold-parallel'
             + ('' if packed is None else f', {layout} modalities')
             + ('' if mesh is None else f', mesh {mesh.shape}') + ')')
    start = time.perf_counter()
    logs = resumable.run(trainer, batches, eps=eps, state_dir=state_dir)
    run_s = time.perf_counter() - start
    epochs = train_config.epochs - resumable.resumed_from
    return logs, epochs * batches['mask'].shape[1], run_s


def _say(mesh, text: str) -> None:
    """Print on rank 0 (always without a mesh)."""
    if mesh is None or mesh.primary:
        print(text)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    common.add_common_flags(parser)
    parser.add_argument('--device', dest='device', default='cuda',
                        help='torch device to train on (default cuda); cuda '
                             'runs the kernels, cpu their plain versions')
    parser.add_argument('--lr_schedule', dest='lr_schedule',
                        default='constant', choices=['constant', 'cyclic'],
                        help='constant reproduces the reference (its cyclic '
                             'assignment is a no-op); cyclic enables the '
                             'intended triangular schedule.')
    parser.add_argument('--fold_parallel', dest='fold_parallel',
                        action='store_true',
                        help='the port always trains every fold at once; '
                             'required by --mesh, as in the JAX CLI')
    parser.add_argument('--batch_size', dest='batch_size', type=int,
                        default=256,
                        help='training batch size (the reference hardcodes '
                             '256, train:197); other values are a different '
                             'trajectory.')
    parser.add_argument('--fused_decoder', dest='fused_decoder',
                        action='store_true',
                        help='run each modality\'s decoder mean head + '
                             'Gaussian NLL (forward and backward) through '
                             'the decoder_nll CUDA kernel pair, which keeps '
                             'the [B, D] means and residuals out of device '
                             'memory; cVAE_multimodal, fp32. Exits (never '
                             'falls back) for another -Model.')
    parser.add_argument('--no_fused_heads', dest='no_fused_heads',
                        action='store_true',
                        help='accepted for the JAX CLI flag surface: the '
                             'port always runs the mu and logvar heads as '
                             'two products (the same math as the merged '
                             'head)')
    parser.add_argument('--fused_train_step', dest='fused_train_step',
                        action='store_true',
                        help='run each optimizer step (forward and '
                             'hand-derived backward of every fold) as one '
                             'fused train-step CUDA kernel call on the '
                             'packed layout: K5 in fp32, K6 under '
                             '--precision bf16; cVAE_multimodal, poe/gpoe/'
                             'moe/mopoe, 1-3 hidden layers of widths up to '
                             '648 in fp32 (432 in bf16). Exits (never '
                             'falls back) on a configuration or a -Model it '
                             'does not take.')
    parser.add_argument('--precision', dest='precision', default='fp32',
                        choices=['fp32', 'bf16'],
                        help='bf16 runs the forward in bfloat16 with fp32 '
                             'master weights and loss reductions (the '
                             'per-modality and packed layouts); with '
                             '--fused_train_step it runs K6. Exits with '
                             '--fused_decoder (K4 takes fp32).')
    parser.add_argument('--remat', dest='remat', action='store_true',
                        help='recompute the forward inside the backward '
                             '(torch.utils.checkpoint): activation memory '
                             'for compute; the same values bit for bit. '
                             'The plain loss only.')
    parser.add_argument('--stream_shards', dest='stream_shards', type=int,
                        default=0,
                        help='out-of-core training for cohorts whose batches '
                             'do not fit the card: split each epoch into S '
                             'contiguous batch shards, pinned on the host, '
                             'and upload shard i+1 on a side CUDA stream '
                             'while shard i computes (peak batch memory ~2/S '
                             'of the cohort). Bit-equal to the resident '
                             'trainer; not with --fold_parallel, '
                             '--packed_xla or --fused_train_step. 0 '
                             "disables; -1 sizes S from the card's "
                             'memory.')
    parser.add_argument('--profile_dir', dest='profile_dir', default=None,
                        help='write a torch.profiler trace (Chrome trace '
                             "JSON: CPU activity, and the card's kernels "
                             'and copies) of the run into this directory.')
    parser.add_argument('--packed_xla', dest='packed_xla',
                        action='store_true',
                        help='train on a packed-modality layout: every '
                             'layer one batched product over the modalities '
                             '(mixed-width cvae-skeleton cohorts on the '
                             'pad-free width-grouped layout, uniform widths '
                             'padded, the DMVAE family split-latent); where '
                             'the configuration does not take it, says why '
                             'and trains the per-modality layout.')
    parser.add_argument('--in_memory_fusion', dest='in_memory_fusion',
                        action='store_true',
                        help='build the UCA early-fusion modality by '
                             'concatenating the scaled base blocks in memory '
                             '(numerically identical; skips reading the '
                             'early_fusion CSV).')
    common.add_resume_flags(parser)
    common.add_mesh_flag(parser)
    common.add_ep_mesh_flag(parser, EP_USAGE)
    parser.add_argument('--warmup_only', dest='warmup_only',
                        action='store_true',
                        help='a TPU compile-cache warm-up: not ported '
                             '(raises); see ROADMAP.md')
    return parser


def run(argv=None, project_root=None):
    args = build_parser().parse_args(argv)
    common.apply_post_parse_defaults(args)
    with common.profiled(args):
        main(args, project_root=project_root)
    from ..parallel import distributed

    distributed.shutdown()


if __name__ == '__main__':
    run()
