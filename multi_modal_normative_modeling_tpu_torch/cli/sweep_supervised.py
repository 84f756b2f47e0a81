"""The supervised grid: procedures x hidden shapes x epoch counts x
learning-rate pairs (counterpart of cli/sweep_supervised.py).

The reference's flagship sweep (commands_list11_adhd.sh:7-84) relaunches
train -> test -> group analysis once per grid point. This engine runs the
same grid and writes the same per-point artifacts (per-fold checkpoints,
deviation CSVs, result_baseline blocks) with the training deduplicated:

* every grid point trains all folds at once (``MultiFoldTrainer``);
* the epochs axis collapses into one run to max(E) with a snapshot at each
  requested E (``MultiFoldTrainer.run_milestones``): a run in chunks is the
  uninterrupted run bit for bit, and a run's first E epochs are the E-epoch
  run, so each snapshot is the standalone run at that epoch count;
* under the reference's effective learning rate (SURVEY.md Q1: its cyclic
  assignment is a no-op, every (base, max) pair trains at the constant
  1e-4) the lr axis is trained once and the other pairs are recorded as
  deduped; with ``--lr_schedule cyclic`` every pair trains;
* the fold ids and each procedure's data prep and batches are shared by
  its grid points;
* with ``--packed_xla`` every grid point trains on the packed layout
  ``train.grouped.select_packed_trainer`` picks (width-grouped for a
  mixed-width cvae-skeleton procedure, padded for uniform widths,
  split-latent for the DMVAE family), the packed batches built once per
  procedure; ``--precision bf16`` runs there for cVAE_multimodal;
* without ``--packed_xla``, ``--precision bf16`` trains the per-modality
  layout with its forward in bfloat16 (fp32 master weights), every model;
* ``--mesh F,D[,M]`` trains every grid point on a mesh of ranks
  (``MultiFoldTrainer(mesh=)``, one process a rank under ``python -m
  torch.distributed.run``) and scores it with the test stage's ``--mesh``;
  ``--ep_mesh F,M,D`` trains every point expert-parallel on the padded
  packed layout (``packed_fold_shardings``, as the JAX sweep) and scores it
  with the test stage's ``--ep_mesh``. Rank 0 writes every file.

At each milestone the port's test stage (``test_supervised.main``: on CUDA
the encoder and decode+deviation kernels once per modality) and analysis
stage run on the snapshot's checkpoints. Summary:
outputs/sweep_supervised_results.json, one record per grid point, and the
run log's sweep_start, point_done and sweep_end events.

    python -m multi_modal_normative_modeling_tpu_torch.cli.sweep_supervised \\
        -R ADHD -K 10 --procedures SM-sMRI SE-gPoE \\
        --hz_grid '110 110 10;460 460 40' --epochs_list 50 500 1000 \\
        --lr_grid '1e-4:5e-3,1e-5:5e-3' [--device cpu]
        [--packed_xla] [--precision bf16] [--mesh F,D[,M] | --ep_mesh F,M,D]
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import pandas as pd

from .. import registry
from ..parallel import MultiFoldTrainer, stack_fold_batches
from ..train import TrainConfig
from ..train.grouped import select_packed_trainer
from ..train.packed import packed_supported
from ..train.trainer import DeviceBatches
from ..utils.logging import RunLog
from . import common, group_analysis, test_supervised
from .train_supervised import EpsFn, default_init

EP_USAGE = '2,2,2 (fold,modality,data)'


def parse_hz_grid(spec: str):
    """'110 110 10;1024 512 256 32;20 10' -> [[110,110,10], ...]."""
    shapes = []
    for part in spec.split(';'):
        part = part.strip()
        if part:
            shapes.append([int(tok) for tok in part.replace(',', ' ').split()])
    if not shapes:
        raise ValueError(f'empty hz grid: {spec!r}')
    return shapes


def parse_lr_grid(spec: str):
    """'1e-4:5e-3,1e-5:5e-4' -> [(1e-4, 5e-3), (1e-5, 5e-4)]."""
    pairs = []
    for part in spec.split(','):
        part = part.strip()
        if part:
            base, _, mx = part.partition(':')
            pairs.append((float(base), float(mx or base)))
    if not pairs:
        raise ValueError(f'empty lr grid: {spec!r}')
    return pairs


def _point_args(args, procedure: str, hz, epochs: int, base_lr: float,
                max_lr: float) -> argparse.Namespace:
    """The namespace one reference launch of a grid point would parse; the
    test and analysis stages and the result_baseline headers read it."""
    if getattr(args, 'combine', None):
        combine = args.combine
    else:
        combine = procedure.split('-')[1] if '-' in procedure else procedure
    return argparse.Namespace(
        dataset_resourse=args.dataset_resourse,
        hz_para_list=list(hz),
        procedure=procedure,
        combine=combine,
        epochs=int(epochs),
        n_splits=args.n_splits,
        oversample_percentage=args.oversample_percentage,
        model=args.model,
        single_modality=None,
        base_learning_rate=base_lr,
        max_learning_rate=max_lr,
        training_class=args.training_class,
        lr_schedule=args.lr_schedule,
        precision=getattr(args, 'precision', 'fp32'),
        in_memory_fusion=getattr(args, 'in_memory_fusion', False),
        emit_latent=False,
        fused_inference=False,
        threshold_method='roc',
        device=getattr(args, 'device', 'cuda'),
        mesh=getattr(args, 'mesh', None),
        ep_mesh=getattr(args, 'ep_mesh', None),
    )


def main(args, project_root=None, init_fn: Optional[common.InitFn] = None,
         eps_fn: Optional[EpsFn] = None,
         score_eps_fn: Optional[test_supervised.EpsFn] = None,
         timings: Optional[dict] = None):
    """The hooks are the train CLI's and the test stage's: ``init_fn(model)``
    the fold-stacked model's initial weights (default: the train CLI's),
    ``eps_fn(valid [F, NB], epochs, rows, latent)`` the training noise of
    every step up to the largest epoch count, ``score_eps_fn`` the test
    stage's noise (tests replay the JAX package's draws). ``timings``, when
    given, receives the phases' walls. Returns the records."""
    packed = getattr(args, 'packed_xla', False)
    precision = getattr(args, 'precision', 'fp32')
    device = common.resolve_device(getattr(args, 'device', 'cuda'), 'train')
    mesh, mesh_shardings, ep_mesh, ep_sizes = _meshes(args, packed, device)
    run_mesh = mesh or ep_mesh
    if run_mesh is not None:
        device = run_mesh.device
    primary = common.primary(run_mesh)
    procedures = args.procedures
    epochs_list = sorted(set(int(e) for e in args.epochs_list))
    if epochs_list[0] < 1:
        raise ValueError(f'epoch counts must be >= 1: {args.epochs_list}')
    hz_grid = parse_hz_grid(args.hz_grid)
    lr_grid = parse_lr_grid(args.lr_grid)
    max_epochs = epochs_list[-1]
    timings = {} if timings is None else timings
    walls = common.StageWalls(timings.setdefault('walls', {}),
                              accumulate=True)
    start = time.perf_counter()

    project_root = Path(project_root) if project_root else Path.cwd()
    output_dir = project_root / 'outputs'
    kfold_dir = output_dir / 'kfold_analysis'
    model_dir = kfold_dir / 'supervised_cvae'
    model_dir.mkdir(parents=True, exist_ok=True)

    if args.lr_schedule == 'cyclic':
        lr_points, lr_deduped = lr_grid, []
    else:
        # SURVEY.md Q1: a constant effective LR, every (base, max) pair
        # trains alike: compute the first, record the rest as deduped
        lr_points, lr_deduped = lr_grid[:1], lr_grid[1:]
    n_points = (len(procedures) * len(hz_grid) * len(epochs_list)
                * len(lr_grid))
    n_runs = len(procedures) * len(hz_grid) * len(lr_points)
    say = print if primary else (lambda *a, **k: None)
    say(f'sweep grid: {len(procedures)} procedures x {len(hz_grid)} shapes'
        f' x {len(epochs_list)} epoch counts x {len(lr_grid)} lr pairs '
        f'= {n_points} points -> {n_runs} training runs '
        f'(fold-parallel, epoch milestones'
        f'{", lr axis deduped" if lr_deduped else ""})')
    run_log = RunLog(model_dir / 'run_log.jsonl') if primary else None
    if primary:
        run_log.event('sweep_start', points=n_points, runs=n_runs,
                      args=dict(vars(args)))

    np.random.seed(42)
    # the fold ids depend only on (resource, training class, K, oversample)
    participants_path = project_root / 'data' / args.dataset_resourse / 'y.csv'
    if primary:
        ids_df = pd.read_csv(participants_path)
        hc_label = registry.get_hc_label(args.dataset_resourse)
        training_label = hc_label if args.training_class == 'nm' else 0
        common.generate_kfold_ids(
            ids_df[ids_df['DIA'] == training_label],
            ids_df[ids_df['DIA'] != training_label],
            oversample_percentage=args.oversample_percentage,
            n_splits=args.n_splits, project_root=project_root)
    common.barrier(run_mesh)

    records = []
    n_folds = args.n_splits
    for procedure in procedures:
        dataset_names = registry.get_datasets_name(args.dataset_resourse,
                                                   procedure)
        if ep_mesh is not None:
            indivisible = common.ep_mesh_divisibility(
                ep_sizes, n_folds, 256, len(dataset_names))
            if indivisible:
                raise SystemExit(
                    f'--ep_mesh {args.ep_mesh} ({procedure}): {indivisible}')
        prep_args = _point_args(args, procedure, hz_grid[0], max_epochs,
                                *lr_grid[0])
        with walls('prep'):
            folds, input_dim_list, c_dim = common.prepare_folds(
                prep_args, project_root, kfold_dir, model_dir, dataset_names,
                participants_path)
            max_n = max(f[0][0].shape[0] for f in folds)
            host_batches = stack_fold_batches(
                [f[0] for f in folds], [f[1] for f in folds], 256)
            # the packed path trains on its packed batches alone, built
            # once per procedure at its first grid point; a run on a mesh
            # takes its part of the host batches
            batches = (host_batches if run_mesh is not None
                       else None if packed
                       else DeviceBatches(host_batches, device))
        if packed or ep_mesh is not None:
            # the packed layouts feed one covariate block to every modality
            flag = '--ep_mesh' if ep_mesh is not None else '--packed_xla'
            cov_reason = common.uniform_covariates(folds)
            if cov_reason:
                raise SystemExit(
                    f'{flag} unavailable ({procedure}): {cov_reason}')

        for hz in hz_grid:
            for base_lr, max_lr in lr_points:
                pa = _point_args(args, procedure, hz, max_epochs, base_lr,
                                 max_lr)
                config_dict = common.model_config_dict(
                    pa, input_dim_list, c_dim, len(dataset_names))
                with walls('train'):
                    model = common.build_model_from_config(config_dict,
                                                           folds=n_folds)
                    if init_fn is not None:
                        init_fn(model)
                    else:
                        default_init(model, config_dict['model'])
                    model.to(device)
                    train_config = TrainConfig(
                        epochs=max_epochs, batch_size=256,
                        learning_rate=1e-4, combine=pa.combine,
                        lr_schedule=args.lr_schedule, base_lr=base_lr,
                        max_lr=max_lr, shuffle=False, seed=42,
                        precision=precision)
                    if ep_mesh is not None:
                        from ..parallel.modality import (
                            packed_fold_shardings,
                        )
                        from ..train.packed import PackedMultiFoldTrainer

                        ok, reason = packed_supported(model, train_config)
                        if not ok:
                            raise SystemExit(
                                f'--ep_mesh unavailable ({reason})')
                        trainer = PackedMultiFoldTrainer(
                            model, train_config, max_n, mesh=ep_mesh,
                            shardings_fn=packed_fold_shardings)
                    elif packed:
                        ok, reason = packed_supported(model, train_config)
                        if not ok:
                            raise SystemExit(f'--packed_xla unavailable '
                                             f'({reason})')
                        pk_cls, _, _ = select_packed_trainer(model)
                        trainer = pk_cls(model, train_config, max_n)
                        if batches is None:
                            batches = trainer.prepare_batches(host_batches)
                    else:
                        trainer = MultiFoldTrainer(
                            model, train_config, max_n, mesh=mesh,
                            shardings_fn=mesh_shardings)
                    draws = {}
                    if eps_fn is not None:
                        draws['eps'] = eps_fn(host_batches['valid'],
                                              max_epochs, 256,
                                              model.noise_dim)
                    stream = trainer.run_milestones(batches, epochs_list,
                                                    **draws)
                for epochs, per_fold, logs in _timed(stream, walls, 'train'):
                    point = _point_args(args, procedure, hz, epochs, base_lr,
                                        max_lr)
                    with walls('artifacts'):
                        # checkpoints at every milestone (the test stage
                        # reads them), loss plots at the run's last only
                        if primary:
                            common.emit_fold_artifacts(
                                model_dir,
                                [{k: v[f] for k, v in logs.items()}
                                 for f in range(n_folds)],
                                per_fold, config_dict, n_folds,
                                plot=epochs == max_epochs)
                        common.barrier(run_mesh)
                    with walls('test stage'):
                        test_supervised.main(point, project_root=project_root,
                                             eps_fn=score_eps_fn)
                    with walls('analysis'):
                        stats = (group_analysis.main(
                            point, project_root=project_root)
                            if primary else None)
                        if run_mesh is not None:
                            stats = run_mesh.all_gather_object(stats)[0]
                    stats = {k: [float(x) for x in v]
                             for k, v in stats.items()}
                    rec = dict(procedure=procedure, hz_para_list=list(hz),
                               epochs=epochs, base_learning_rate=base_lr,
                               max_learning_rate=max_lr, stats=stats)
                    records.append(rec)
                    if primary:
                        run_log.event('point_done', **rec)
                    say(f'[sweep] {procedure} hz={hz} E={epochs} '
                        f'lr=({base_lr:g},{max_lr:g}) '
                        f'auc={stats["auc"]}', flush=True)
                    for dbase, dmax in lr_deduped:
                        records.append(dict(
                            procedure=procedure, hz_para_list=list(hz),
                            epochs=epochs, base_learning_rate=dbase,
                            max_learning_rate=dmax, stats=stats,
                            deduped_from=dict(base_learning_rate=base_lr,
                                              max_learning_rate=max_lr)))
                if lr_deduped:
                    say(f'[sweep] {procedure} hz={hz}: '
                        f'{len(lr_deduped)} lr pairs deduped (constant '
                        f'effective LR, SURVEY.md Q1); pass '
                        f'--lr_schedule cyclic to train them')

    if primary:
        summary_path = output_dir / 'sweep_supervised_results.json'
        summary_path.write_text(json.dumps(records, indent=1))
        run_log.event('sweep_end', points=len(records),
                      summary=str(summary_path))
        print(f'sweep summary: {summary_path} ({len(records)} grid points)')
        walls.report('sweep_supervised')
        print(f'sweep_supervised total wall '
              f'{time.perf_counter() - start:.3f} s', flush=True)
    common.barrier(run_mesh)
    return records


def _meshes(args, packed: bool, device):
    """(mesh, its shardings, ep mesh, its sizes) of --mesh / --ep_mesh, with
    the JAX CLI's conflicts in its order and words
    (cli/sweep_supervised.py:194-233)."""
    mesh, shardings = common.parse_mesh(getattr(args, 'mesh', None),
                                        args.n_splits, 256, device)
    if mesh is not None:
        common.announce_mesh(mesh, 'sweep training programs run')
    if packed:
        conflicts = [n for n, on in [('--mesh', mesh is not None),
                                     ('--ep_mesh',
                                      bool(getattr(args, 'ep_mesh', None)))]
                     if on]
        if conflicts:
            raise SystemExit('--packed_xla is mutually exclusive with '
                             + ', '.join(conflicts))
        print('sweep training runs on the packed-modality layout '
              '(--packed_xla)')
    ep_mesh = ep_sizes = None
    if getattr(args, 'ep_mesh', None):
        if mesh is not None:
            raise SystemExit('--ep_mesh is mutually exclusive with --mesh')
        ep_mesh, ep_sizes = common.parse_ep_mesh(args.ep_mesh, (3,),
                                                 EP_USAGE, device)
        common.announce_mesh(ep_mesh,
                             'sweep training programs run expert-parallel')
    return mesh, shardings, ep_mesh, ep_sizes


def _timed(stream, walls: common.StageWalls, stage: str):
    """The items of ``stream``, the time of producing each under ``stage``
    (the milestone generator trains between its items)."""
    while True:
        with walls(stage):
            item = next(stream, None)
        if item is None:
            return
        yield item


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('-R', '--dataset_resourse', dest='dataset_resourse',
                        default='ADNI', type=str)
    parser.add_argument('-K', '--n_splits', dest='n_splits', type=int,
                        default=10)
    parser.add_argument('-O', '--oversample_percentage',
                        dest='oversample_percentage', type=float, default=1)
    parser.add_argument('-Model', '--model', dest='model',
                        default='cVAE_multimodal', type=str)
    parser.add_argument('-TrainingClass', '--training_class',
                        dest='training_class', default='nm', type=str)
    parser.add_argument('-C', '--combine', dest='combine', default=None,
                        type=str,
                        help='override the per-procedure fusion (defaults to '
                             'procedure.split("-")[1], the reference rule).')
    parser.add_argument('--procedures', dest='procedures', nargs='+',
                        default=['UCA-gPoE'],
                        help='procedure grid axis (e.g. SM-sMRI SM-fMRI '
                             'SE-MoE SE-PoE SE-gPoE).')
    parser.add_argument('--epochs_list', dest='epochs_list', nargs='+',
                        type=int, default=[200],
                        help='epoch-count grid axis; collapsed into one '
                             'training run to max(E) with snapshots.')
    parser.add_argument('--hz_grid', dest='hz_grid',
                        default='110 110 10',
                        help="semicolon-separated hidden shapes, e.g. "
                             "'110 110 10;1024 512 256 32;20 10'.")
    parser.add_argument('--lr_grid', dest='lr_grid', default='1e-4:5e-3',
                        help="comma-separated base:max pairs, e.g. "
                             "'1e-5:5e-5,1e-4:5e-3'. Deduped unless "
                             "--lr_schedule cyclic (SURVEY.md Q1).")
    parser.add_argument('--lr_schedule', dest='lr_schedule',
                        default='constant', choices=['constant', 'cyclic'])
    parser.add_argument('--precision', dest='precision', default='fp32',
                        choices=['fp32', 'bf16'],
                        help='bf16 runs the forward in bfloat16 with fp32 '
                             'master weights (the per-modality layout, or '
                             'with --packed_xla the packed layouts of '
                             'cVAE_multimodal)')
    parser.add_argument('--device', dest='device', default='cuda',
                        help='torch device to run on (default cuda); cuda '
                             'runs the kernels, cpu their plain versions')
    parser.add_argument('--no_fused_heads', dest='no_fused_heads',
                        action='store_true',
                        help='accepted for the JAX CLI flag surface: the '
                             'port always runs the mu and logvar heads as '
                             'two products (the same math as the merged '
                             'head)')
    parser.add_argument('--mesh', dest='mesh', default=None,
                        metavar='F,D[,M]',
                        help='train and score every grid point on a mesh of '
                             'ranks (python -m torch.distributed.run): '
                             'folds over F, rows over D, the weights over '
                             'M; exclusive with --ep_mesh/--packed_xla.')
    common.add_ep_mesh_flag(parser, EP_USAGE)
    parser.add_argument('--packed_xla', dest='packed_xla',
                        action='store_true',
                        help='train every grid point on the packed-modality '
                             'layout (mixed-width cvae-skeleton procedures '
                             'on the pad-free width-grouped layout, uniform '
                             'widths padded, the DMVAE family '
                             'split-latent); the packed batches are built '
                             'once per procedure.')
    parser.add_argument('--in_memory_fusion', dest='in_memory_fusion',
                        action='store_true',
                        help='build the UCA early-fusion modality by '
                             'concatenating the scaled base blocks in memory '
                             '(numerically identical; skips reading the '
                             'early_fusion CSV).')
    return parser


def run(argv=None, project_root=None):
    args = build_parser().parse_args(argv)
    records = main(args, project_root=project_root)
    from ..parallel import distributed

    distributed.shutdown()
    return records


if __name__ == '__main__':
    run()
