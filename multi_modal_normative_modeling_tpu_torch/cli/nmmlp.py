"""nm-MLP variant: train / test / analyze / all (counterpart of
cli/nmmlp.py).

The reference's only truly normative trainer: the training rows are the
healthy controls of each fold (nmmlp:314), the fold ids split the controls
and the AD group only (nmmlp:295), and its cyclic LR schedule works
(nmmlp:380-381, base 1e-6 to max 5e-5). The model is the port's
``MultimodalCVAE(variant="nmmlp")``; every fold trains at once.

``test`` scores each fold's test rows through ``pred_recon_fused`` (on CUDA
the encoder kernel, then the decode+deviation kernel, once per modality for
every fold) and writes the per-fold CSVs in the reference's column order
(the feature columns, then participant_id; nmmlp:498-511) plus
diagnosis_results.csv, the mean deviation over modalities (nmmlp:513-521).
``analyze`` computes ROC and Youden metrics from those CSVs with the
port's numpy ``roc_curve`` / ``auc`` and appends
outputs/analysis_results/performance_metrics.txt.

``--fold_parallel --mesh F,D[,M]`` trains on a mesh of ranks (one process
each, ``python -m torch.distributed.run``) and scores with F,D (the 'model'
axis folded into 'data'), each rank its folds' rows, as the test stage
does; rank 0 writes every file and runs ``analyze``.

    python -m multi_modal_normative_modeling_tpu_torch.cli.nmmlp all \\
        -R ADNI -P SE-MoE -E 200 -K 5 [--device cpu]
        [--checkpoint_every N [--resume]] [--packed_xla]
        [--fold_parallel --mesh F,D[,M]]
"""
from __future__ import annotations

import argparse
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import pandas as pd
import torch

from .. import registry
from ..data.preprocess import fit_robust_scaler, one_hot_covariates
from ..evaluation.metrics import auc, roc_curve
from ..evaluation.reports import append_performance_metrics
from ..infer.emitters import write_csv
from ..interop import params_from_jax, params_to_jax, read_flax_checkpoint
from ..models import MultimodalCVAE
from ..parallel import (
    MultiFoldTrainer,
    distributed,
    stack_fold_batches,
    stack_params,
)
from ..train import TrainConfig
from . import common
from .test_supervised import EpsFn, default_eps


def _dirs(project_root: Path):
    outputs = project_root / 'outputs'
    kfold = outputs / 'kfold_analysis'
    model = kfold / 'supervised_cvae'
    for d in (outputs, kfold, model):
        d.mkdir(exist_ok=True, parents=True)
    return outputs, kfold, model


def _build_model(input_dim_list, hidden_dim, latent_dim, c_dim, modalities,
                 folds=1, generator=None, device=None):
    return MultimodalCVAE(input_dim_list, hidden_dim, latent_dim, c_dim,
                          modalities, non_linear=True, variant='nmmlp',
                          folds=folds, generator=generator, device=device)


def default_init(model: MultimodalCVAE) -> None:
    """One fold drawn from torch.Generator seeded 42, repeated over the
    folds (the reference re-seeds 42 per fold)."""
    common.init_from_one_fold(model, _build_model(
        model.input_dim_list, model.hidden_dim, model.latent_dim,
        model.c_dim, model.modalities,
        generator=torch.Generator().manual_seed(42)))


def _modality_frames(project_root, args, name, participants_path, ids_path,
                     read):
    columns = registry.get_column_name(args.dataset_resourse, name)
    path = project_root / 'data' / args.dataset_resourse / f'{name}.csv'
    return columns, common.load_dataset(participants_path, ids_path, path,
                                        read)


def train(args, project_root: Path,
          init_fn: Optional[common.InitFn] = None,
          draws_fn: Optional[common.DrawsFn] = None,
          timings: Optional[dict] = None) -> None:
    device = common.resolve_device(getattr(args, 'device', 'cuda'), 'train')
    mesh, shardings_fn = common.parse_run_mesh(args, args.n_splits, 256,
                                               device)
    device = device if mesh is None else mesh.device
    timings = {} if timings is None else timings
    walls = common.StageWalls(timings.setdefault('walls', {}))
    outputs, kfold_dir, model_dir = _dirs(project_root)
    np.random.seed(42)
    names = registry.get_datasets_name(args.dataset_resourse, args.procedure)
    modalities = len(names)
    participants_path = project_root / 'data' / args.dataset_resourse / 'y.csv'
    ids_df = pd.read_csv(participants_path)
    hc_label = registry.get_hc_label(args.dataset_resourse)

    with walls('train data'):
        if common.primary(mesh):
            common.generate_kfold_ids(
                ids_df[ids_df['DIA'] == hc_label],
                ids_df[ids_df['DIA'] == 0],  # the AD group only (nmmlp:295)
                oversample_percentage=args.oversample_percentage,
                n_splits=args.n_splits, project_root=project_root)
        common.barrier(mesh)

        def prep(job):
            fold, name = job
            columns, train_df = _modality_frames(
                project_root, args, name, participants_path,
                common.fold_paths(kfold_dir, fold)[0], read)
            # normative training: the healthy controls only (nmmlp:314)
            train_df = train_df.loc[train_df['DIA'] == hc_label]
            data = fit_robust_scaler(
                train_df[columns].values)[0].astype(np.float32)
            return data, one_hot_covariates(
                train_df[['DIA', 'PTGENDER', 'AGE']])

        for fold in range(args.n_splits):
            (model_dir / f'{fold:03d}').mkdir(exist_ok=True)
        with ThreadPoolExecutor(max_workers=8) as pool:
            read = common.shared_tables(pool, project_root,
                                        args.dataset_resourse, names,
                                        participants_path)
            preps = list(pool.map(prep, [(f, n) for f in range(args.n_splits)
                                         for n in names]))
        folds = [([d for d, _ in preps[f * modalities:(f + 1) * modalities]],
                  [c for _, c in preps[f * modalities:(f + 1) * modalities]])
                 for f in range(args.n_splits)]
        input_dim_list = [d.shape[1] for d in folds[0][0]]
        c_dim = folds[0][1][0].shape[1]

    n_folds = len(folds)
    model = _build_model(input_dim_list, args.hz_para_list[:-1],
                         args.hz_para_list[-1], c_dim, modalities,
                         folds=n_folds)
    (init_fn or default_init)(model)
    model.to(device)
    # the working cyclic schedule (nmmlp:363-364, :380-381); its step size
    # from fold 0's rows, as the JAX CLI's per-fold trainer takes it
    config = TrainConfig(epochs=args.epochs, batch_size=256,
                         combine=args.combine, lr_schedule='cyclic',
                         base_lr=1e-6, max_lr=5e-5, shuffle=False, seed=42)
    print('Training model...')
    with walls('train'):
        batches = stack_fold_batches([f[0] for f in folds],
                                     [f[1] for f in folds], config.batch_size)
        draws = {}
        if draws_fn is not None:
            draws = draws_fn(batches['valid'], config.epochs,
                             config.batch_size, model)
        resumable = common.Resumable(args)
        # one whole-run train state in the model dir (the JAX CLI keeps
        # one per fold on its sequential path), a packed layout's in its
        # own dir
        state_dir = model_dir
        packed = (common.packed_layout(model, config, folds, mesh)
                  if getattr(args, 'packed_xla', False) else None)
        if packed is None:
            trainer = MultiFoldTrainer(model, config, folds[0][0][0].shape[0],
                                       mesh=mesh, shardings_fn=shardings_fn)
        else:
            cls, layout, tag = packed
            trainer = cls(model, config, folds[0][0][0].shape[0])
            state_dir = common.packed_state_dir(model_dir, tag, resumable)
            print(f'train model (all folds fold-parallel, {layout} '
                  'modalities)')
        start = time.perf_counter()
        logs = resumable.run(trainer, batches, state_dir=state_dir, **draws)
        timings['train_run_s'] = time.perf_counter() - start
        timings['train_steps'] = ((config.epochs - resumable.resumed_from)
                                  * batches['mask'].shape[1])
    if not common.primary(mesh):
        mesh.barrier()   # rank 0 writes the checkpoints
        return
    with walls('checkpoints'):
        common.emit_fold_artifacts(
            model_dir, [{k: v[f] for k, v in logs.items()}
                        for f in range(n_folds)],
            [params_to_jax(model, fold=f) for f in range(n_folds)], {
                'model': 'nmmlp',
                'input_dim_list': list(map(int, input_dim_list)),
                'hidden_dim': list(args.hz_para_list[:-1]),
                'latent_dim': int(args.hz_para_list[-1]),
                'c_dim': int(c_dim), 'modalities': modalities,
                'non_linear': True, 'combine': args.combine,
            }, n_folds)
    common.barrier(mesh)


def test(args, project_root: Path, eps_fn: Optional[EpsFn] = None,
         timings: Optional[dict] = None) -> None:
    device = common.resolve_device(getattr(args, 'device', 'cuda'), 'score')
    mesh = common.parse_infer_mesh(getattr(args, 'mesh', None), device)
    device = device if mesh is None else mesh.device
    eps_fn = eps_fn or default_eps
    timings = {} if timings is None else timings
    walls = common.StageWalls(timings.setdefault('walls', {}))
    outputs, kfold_dir, model_dir = _dirs(project_root)
    participants_path = project_root / 'data' / args.dataset_resourse / 'y.csv'
    hc_label = registry.get_hc_label(args.dataset_resourse)
    names = registry.get_datasets_name(args.dataset_resourse, args.procedure)
    n_mod = len(names)

    # ---- per-fold host prep + checkpoint restore --------------------------
    with walls('test data'):
        def prep(job):
            fold, name = job
            train_ids, test_ids = common.fold_paths(kfold_dir, fold)
            columns, train_df = _modality_frames(
                project_root, args, name, participants_path, train_ids, read)
            train_df = train_df.loc[train_df['DIA'] == hc_label]
            _, test_df = _modality_frames(project_root, args, name,
                                          participants_path, test_ids, read)
            _, scaler = fit_robust_scaler(train_df[columns].values)
            # float64 for the CSVs, downcast for the device
            return (columns, test_df,
                    scaler.transform(test_df[columns].values))

        with ThreadPoolExecutor(max_workers=8) as pool:
            read = common.shared_tables(pool, project_root,
                                        args.dataset_resourse, names,
                                        participants_path)
            preps = list(pool.map(prep, [(f, n) for f in range(args.n_splits)
                                         for n in names]))
        pending, config = [], None
        for fold in range(args.n_splits):
            fold_dir = model_dir / f'{fold:03d}'
            fold_dir.mkdir(exist_ok=True)
            fold_preps = preps[fold * n_mod:(fold + 1) * n_mod]
            frames = [p[1] for p in fold_preps]
            common.assert_modalities_aligned(frames, f'nmmlp test fold {fold}')
            if not (fold_dir / 'cVAE_model.ckpt').exists():
                print('Model not found, please train the model first.')
                return
            print('Loading trained model...')
            params, config = read_flax_checkpoint(fold_dir)
            pending.append({
                'fold': fold, 'dir': fold_dir, 'params': params,
                'test_data_list': [p[2] for p in fold_preps],
                'clinical_df': frames[0],
                'columns_list': [p[0] for p in fold_preps],
                # the last modality's (nmmlp:178)
                'test_cov': one_hot_covariates(
                    frames[-1][['DIA', 'AGE', 'PTGENDER']]),
            })

    # ---- one scoring call over the stacked fold axis (on a mesh, this
    # rank's folds and rows of it, gathered) -------------------------------
    common.check_infer_fold_axis(mesh, len(pending), 'folds with checkpoints')
    with walls('score'):
        rows = common.padded_rows(max(j['test_data_list'][0].shape[0]
                                      for j in pending), mesh)
        folds, part = common.mesh_parts(mesh, len(pending), rows)
        mine = pending[folds]
        # the SAVED architecture, not the flags: the reference's test stage
        # unpickles the trained modules
        model = _build_model(config['input_dim_list'], config['hidden_dim'],
                             config['latent_dim'], config['c_dim'],
                             config['modalities'], folds=len(mine))
        params_from_jax(stack_params([j['params'] for j in mine]), model,
                        device)
        xes = [common.stack_padded([j['test_data_list'][m] for j in mine],
                                   rows, device, part) for m in range(n_mod)]
        c = common.stack_padded([j['test_cov'] for j in mine], rows, device,
                                part)
        eps = torch.from_numpy(np.ascontiguousarray(np.stack([
            np.asarray(eps_fn(j['fold'], rows, model.noise_dim),
                       np.float32)[part] for j in mine]))).to(device)
        recons, devs = model.pred_recon_fused(xes, [c] * n_mod, args.combine,
                                              eps=eps)
        gathered = common.gather_parts(
            mesh, [t.cpu().numpy() for t in list(recons) + list(devs)],
            len(pending))
        all_preds, all_devs = gathered[:n_mod], gathered[n_mod:]
        timings['score_rows'] = rows
    if not common.primary(mesh):
        mesh.barrier()   # rank 0 writes the CSVs
        return

    # ---- per-fold CSVs ------------------------------------------------------
    with walls('write'):
        for i, job in enumerate(pending):
            n_rows = job['test_data_list'][0].shape[0]
            predictions = [all_preds[m][i, :n_rows] for m in range(n_mod)]
            deviations = [all_devs[m][i, :n_rows] for m in range(n_mod)]
            participant_ids = job['clinical_df']['participant_id'].values
            for idx, name in enumerate(names):
                out_dir = job['dir'] / name
                out_dir.mkdir(exist_ok=True)
                columns = job['columns_list'][idx]
                normalized = pd.DataFrame(job['test_data_list'][idx],
                                          columns=columns)
                normalized['participant_id'] = participant_ids
                write_csv(out_dir / f'normalized_{name}.csv', normalized)
                recon = pd.DataFrame(predictions[idx], columns=columns)
                recon['participant_id'] = participant_ids
                write_csv(out_dir / f'reconstruction_{name}.csv', recon)
                pd.DataFrame({
                    'participant_id': participant_ids,
                    'Reconstruction error': deviations[idx],
                }).to_csv(out_dir / f'reconstruction_error_{name}.csv',
                          index=False)
            diagnosis = np.mean(np.stack(deviations), axis=0)
            pd.DataFrame({
                'participant_id': participant_ids,
                'Diagnosis': diagnosis.ravel(),
                'True_Label': (job['clinical_df']['DIA'] != hc_label
                               ).astype(int).values,
            }).to_csv(job['dir'] / 'diagnosis_results.csv', index=False)
            print(f'Fold {job["fold"]}:')
    common.barrier(mesh)


def analyze(args, project_root: Path) -> dict:
    outputs, kfold_dir, model_dir = _dirs(project_root)
    aucs, accs, sens, specs, sigs = [], [], [], [], []
    for fold in range(args.n_splits):
        path = model_dir / f'{fold:03d}' / 'diagnosis_results.csv'
        if not path.exists():
            print(f'Diagnosis results not found for fold {fold}. '
                  'Please run the test function first.')
            continue
        frame = pd.read_csv(path)
        labels = frame['True_Label'].values
        scores = frame['Diagnosis'].values
        fpr, tpr, thresholds = roc_curve(labels, scores)
        roc_auc = auc(fpr, tpr)
        aucs.append(roc_auc)
        threshold = thresholds[np.argmax(tpr - fpr)]
        predicted = (scores >= threshold).astype(int)
        accs.append(np.mean(predicted == labels))
        tp = np.sum((predicted == 1) & (labels == 1))
        tn = np.sum((predicted == 0) & (labels == 0))
        fp = np.sum((predicted == 1) & (labels == 0))
        fn = np.sum((predicted == 0) & (labels == 1))
        sens.append(tp / (tp + fn) if (tp + fn) > 0 else 0)
        specs.append(tn / (tn + fp) if (tn + fp) > 0 else 0)
        sigs.append(roc_auc / (1 - roc_auc) if roc_auc < 1 else float('inf'))
        print(f'Fold {fold}: ROC AUC: {roc_auc:.4f}')
    if not aucs:
        print('No diagnosis results found for any fold; nothing to analyze.')
        return {'auc': None, 'auc_std': None}
    print('Overall Performance:')
    print(f'Mean ROC AUC: {np.mean(aucs):.4f} ± {np.std(aucs):.4f}')
    append_performance_metrics(
        outputs / 'analysis_results', np.mean(aucs), np.std(aucs),
        np.mean(accs), np.std(accs), np.mean(sens), np.std(sens),
        np.mean(specs), np.std(specs), np.mean(sigs), np.std(sigs),
    )
    return {'auc': np.mean(aucs), 'auc_std': np.std(aucs)}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='Train, Test, and Analyze the model.')
    parser.add_argument('action', choices=['train', 'test', 'analyze', 'all'],
                        help='Action to perform, train, test, analyze, or all.')
    parser.add_argument('-R', '--dataset_resourse', type=str, default='ADNI',
                        help='Dataset to use for training test and evaluation.')
    parser.add_argument('-H', '--hz_para_list', nargs='+', type=int,
                        default=[110, 110, 10],
                        help='List of paras to perform the analysis.')
    parser.add_argument('-C', '--combine', type=str,
                        help='How to combine all modalities.')
    parser.add_argument('-P', '--procedure', type=str, default='SE-MoE',
                        help='Procedure to perform the analysis.')
    parser.add_argument('-E', '--epochs', type=int, default=200,
                        help='Number of epochs to train the model.')
    parser.add_argument('-K', '--n_splits', type=int, default=5,
                        help='Number of splits for k-fold cross-validation.')
    parser.add_argument('-O', '--oversample_percentage', type=float, default=1,
                        help='Percentage of oversampling of the training data.')
    common.add_variant_flags(parser)
    return parser


def main(args, project_root=None, init_fn: Optional[common.InitFn] = None,
         draws_fn: Optional[common.DrawsFn] = None,
         eps_fn: Optional[EpsFn] = None,
         timings: Optional[dict] = None):
    """The stages ``args.action`` names. ``init_fn``, ``draws_fn`` and
    ``eps_fn`` are the hooks tests replay the JAX package's init and draws
    through (see ``train`` and ``test``); ``timings``, when given, receives
    the stages' walls and the training steps and seconds. Returns
    ``analyze``'s result when it runs."""
    common.require_checkpoint_for_resume(args)
    if args.combine is None:
        args.combine = args.procedure.split('-')[1]
    project_root = Path(project_root) if project_root else Path.cwd()
    timings = {} if timings is None else timings
    result = None
    if args.action in ('train', 'all'):
        train(args, project_root, init_fn, draws_fn, timings)
    if args.action in ('test', 'all'):
        test(args, project_root, eps_fn, timings)
    # a host stage on the files: rank 0's alone on a mesh
    if args.action in ('analyze', 'all') and distributed.rank() == 0:
        with common.StageWalls(timings.setdefault('walls', {}))('analyze'):
            result = analyze(args, project_root)
    common.StageWalls(timings['walls']).report('nmmlp')
    return result


def run(argv=None, project_root=None):
    result = main(build_parser().parse_args(argv), project_root)
    distributed.shutdown()
    return result


if __name__ == '__main__':
    run()
