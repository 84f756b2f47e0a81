"""Regression-head k-fold training on the continuous score FI (counterpart
of cli/regression.py).

KFold over the whole cohort (all subjects, :51-53), raw [AGE, PTGENDER]
covariates (c_dim 2), batch 128 with the per-epoch shuffle (:94), every
fold trained at once on ``RegressionCVAE``; RMSE / MAE / R^2 / MAPE of
each fold's test rows (``evaluation.metrics.evaluate_regression``, no
sklearn), regression_outputs/fold_<k>_{pred,true}.npy, and the full-cohort
ROI-wise deviation CSVs regression_outputs/deviation_fold_<k>_<modality>
_roiwise.csv (``IID,ROI_0..``; the scaler refit on the whole cohort,
:163-192).

On CUDA the FI prediction runs the encoder kernel and the decoder-mean
kernel once per modality for every fold (the head in torch), and the
ROI-wise deviation one modality's pair over the whole cohort. The scoring
noise of fold k is drawn from seed 900 + k (FI) and 800 + k (ROI), the JAX
CLI's PRNGKey seeds, through ``eps_fn`` (tests replay the JAX draws).

Divergence: the JAX CLI also draws fold_<k>_scatter.png with matplotlib,
which the GPU machine does not have; this CLI draws no figure (the .npy
pair holds its data; ROADMAP.md, queue 3).

    python -m multi_modal_normative_modeling_tpu_torch.cli.regression \\
        -R ADNI -P UCA-gPoE -E 500 -K 5 [--device cpu]
        [--checkpoint_every N [--resume]]
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import pandas as pd
import torch

from .. import registry
from ..data.preprocess import fit_robust_scaler
from ..evaluation.metrics import evaluate_regression
from ..infer.emitters import write_csv
from ..models.regression import RegressionCVAE, regression_loss_fn
from ..parallel import MultiFoldTrainer, stack_fold_batches
from ..train import TrainConfig
from . import common

# (seed, rows, latent dim) -> scoring noise [rows, latent dim]
EpsFn = Callable[[int, int, int], np.ndarray]


def default_init(model: RegressionCVAE) -> None:
    """One fold drawn from torch.Generator seeded 42, repeated over the
    folds (the reference re-seeds 42 per fold)."""
    common.init_from_one_fold(model, RegressionCVAE(
        model.input_dim_list, model.hidden_dim, model.latent_dim,
        model.c_dim, model.modalities, model.non_linear, folds=1,
        generator=torch.Generator().manual_seed(42)))


def _fold_data(args, tables, ids_df, train_idx, test_idx, fold):
    """One fold's scaled data, raw covariates and FI; ``tables`` holds each
    modality's table by name, parsed once for every fold."""
    train_ids = ids_df.iloc[train_idx]['IID'].tolist()
    test_ids = ids_df.iloc[test_idx]['IID'].tolist()
    out = {'train_data': [], 'test_data': []}
    train_frames, test_frames = [], []
    for name, modality_df in tables.items():
        columns = registry.get_column_name(args.dataset_resourse, name)
        train_df = pd.merge(modality_df[modality_df['IID'].isin(train_ids)],
                            ids_df, on='IID')
        test_df = pd.merge(modality_df[modality_df['IID'].isin(test_ids)],
                           ids_df, on='IID')
        train_frames.append(train_df)
        test_frames.append(test_df)
        scaled, scaler = fit_robust_scaler(train_df[columns].values)
        out['train_data'].append(scaled.astype(np.float32))
        out['test_data'].append(
            scaler.transform(test_df[columns].values).astype(np.float32))
        out['train_cov'] = train_df[['AGE', 'PTGENDER']].values.astype(
            np.float32)
        out['test_cov'] = test_df[['AGE', 'PTGENDER']].values.astype(
            np.float32)
        out['train_fi'] = train_df['FI'].values.astype(np.float32)
        out['test_fi'] = test_df['FI'].values.astype(np.float32)
    common.assert_modalities_aligned(train_frames,
                                     f'regression train fold {fold}',
                                     key='IID')
    common.assert_modalities_aligned(test_frames,
                                     f'regression test fold {fold}',
                                     key='IID')
    return out


def train_and_test(args, project_root=None,
                   init_fn: Optional[common.InitFn] = None,
                   draws_fn: Optional[common.DrawsFn] = None,
                   eps_fn: Optional[EpsFn] = None,
                   timings: Optional[dict] = None):
    """Train, score and write; returns the per-fold scores. The hooks:
    ``init_fn(model)`` the initial weights (default ``default_init``),
    ``draws_fn`` every training step's noise and each epoch's permutations,
    ``eps_fn(seed, rows, latent)`` the scoring noise (default
    ``common.seeded_eps``). ``timings``, when given, receives the stages'
    walls and the training steps and seconds."""
    common.refuse_not_ported(args, 'regression trainer')
    common.require_checkpoint_for_resume(args)
    device = common.resolve_device(getattr(args, 'device', 'cuda'), 'train')
    eps_fn = eps_fn or common.seeded_eps
    timings = {} if timings is None else timings
    walls = common.StageWalls(timings.setdefault('walls', {}))
    project_root = Path(project_root) if project_root else Path.cwd()
    np.random.seed(42)
    output_dir = project_root / 'regression_outputs'
    output_dir.mkdir(exist_ok=True)
    names = registry.get_datasets_name(args.dataset_resourse, args.procedure)
    n_mod = len(names)
    participants_path = project_root / 'data' / args.dataset_resourse / 'y.csv'
    ids_df = pd.read_csv(participants_path)

    with walls('data'):
        tables = {name: common.read_csv(project_root / 'data'
                                        / args.dataset_resourse
                                        / f'{name}.csv')
                  for name in names}
        fold_data = [
            _fold_data(args, tables, ids_df, train_idx, test_idx, fold)
            for fold, (train_idx, test_idx) in enumerate(
                common.kfold_split(len(ids_df), args.n_splits))]
    n_folds = len(fold_data)
    input_dim_list = [d.shape[1] for d in fold_data[0]['train_data']]
    model = RegressionCVAE(input_dim_list, args.hz_para_list[:-1],
                           args.hz_para_list[-1], c_dim=2, modalities=n_mod,
                           non_linear=True, folds=n_folds)
    (init_fn or default_init)(model)
    model.to(device)
    config = TrainConfig(epochs=args.epochs, batch_size=args.batch_size,
                         learning_rate=args.base_learning_rate,
                         combine=args.combine, shuffle=True, seed=42)
    with walls('train'):
        batches = stack_fold_batches(
            [f['train_data'] for f in fold_data],
            [[f['train_cov']] * n_mod for f in fold_data], config.batch_size,
            extras=[{'fi': f['train_fi'][:, None]} for f in fold_data])
        draws = {}
        if draws_fn is not None:
            draws = draws_fn(batches['valid'], config.epochs,
                             config.batch_size, model)
        trainer = MultiFoldTrainer(
            model, config, max(f['train_data'][0].shape[0]
                               for f in fold_data),
            loss_fn=regression_loss_fn(model, config.combine))
        print('train model (all folds fold-parallel, shuffled every epoch)')
        resumable = common.Resumable(args)
        start = time.perf_counter()
        # one whole-run train state in regression_outputs (the JAX CLI
        # keeps one per fold, or one per packed layout)
        logs = resumable.run(trainer, batches, state_dir=output_dir, **draws)
        timings['train_run_s'] = time.perf_counter() - start
        timings['train_steps'] = ((config.epochs - resumable.resumed_from)
                                  * batches['mask'].shape[1])

    # ---- FI of every fold's test rows: one call over the fold axis -------
    with walls('score FI'):
        rows = common.padded_rows(max(f['test_data'][0].shape[0]
                                      for f in fold_data))
        xes = [common.stack_padded([f['test_data'][m] for f in fold_data],
                                   rows, device) for m in range(n_mod)]
        c = common.stack_padded([f['test_cov'] for f in fold_data], rows,
                                device)
        eps = _fold_eps(eps_fn, 900, n_folds, rows, model.noise_dim, device)
        all_fi = model.pred_fi(xes, [c] * n_mod, args.combine,
                               eps=eps).cpu().numpy()
        timings['score_rows'] = rows

    all_scores = []
    for fold in range(n_folds):
        print(f'=== Fold {fold} ===')
        print(f"[Fold {fold}] final loss: {float(logs['total'][fold, -1]):.4f}"
              f", FI MSE: {float(logs['regression'][fold, -1]):.4f}")
        n_rows = fold_data[fold]['test_data'][0].shape[0]
        preds = all_fi[fold, :n_rows].reshape(-1, 1)
        trues = fold_data[fold]['test_fi'].reshape(-1, 1)
        np.save(output_dir / f'fold_{fold}_pred.npy', preds)
        np.save(output_dir / f'fold_{fold}_true.npy', trues)
        scores = evaluate_regression(trues, preds)
        all_scores.append(scores)
        print(f"[Fold {fold}] RMSE: {scores['RMSE']:.4f}, "
              f"MAE: {scores['MAE']:.4f}, R²: {scores['R2']:.4f}, "
              f"MAPE: {scores['MAPE']:.2f}%")

    # ---- full-cohort ROI-wise deviation per modality, the scaler refit on
    # the whole cohort (reference quirk, :177-179) --------------------------
    with walls('score ROI'):
        all_ids = ids_df['IID'].tolist()
        for modal_idx, name in enumerate(names):
            print(f'Extracting ROI-wise deviation for {name} '
                  f'(all {n_folds} folds)...')
            columns = registry.get_column_name(args.dataset_resourse, name)
            modality_df = pd.read_csv(
                project_root / 'data' / args.dataset_resourse / f'{name}.csv')
            full_df = pd.merge(modality_df[modality_df['IID'].isin(all_ids)],
                               ids_df, on='IID')
            x = fit_robust_scaler(
                full_df[columns].values)[0].astype(np.float32)
            cov = full_df[['AGE', 'PTGENDER']].values.astype(np.float32)
            n = x.shape[0]
            deviations = model.roiwise_deviation(
                _every_fold(x, n_folds, device),
                _every_fold(cov, n_folds, device), modal_idx,
                eps=_fold_eps(eps_fn, 800, n_folds, n, model.noise_dim,
                              device)).cpu().numpy()
            timings['roi_rows'] = n
            iids = full_df['IID'].tolist()
            for fold in range(n_folds):
                out = pd.DataFrame(
                    deviations[fold],
                    columns=[f'ROI_{i}' for i in range(deviations.shape[2])])
                out.insert(0, 'IID', iids)
                write_csv(output_dir /
                          f'deviation_fold_{fold}_{name}_roiwise.csv', out)
    print('Training & evaluation complete.')
    walls.report('regression')
    return all_scores


def _fold_eps(eps_fn, base: int, n_folds: int, rows: int, z_dim: int,
              device) -> torch.Tensor:
    """[F, rows, Z]: fold k's noise from seed base + k."""
    return torch.from_numpy(np.stack([
        np.asarray(eps_fn(base + fold, rows, z_dim), np.float32)
        for fold in range(n_folds)])).to(device)


def _every_fold(a: np.ndarray, n_folds: int, device) -> torch.Tensor:
    """One [rows, width] block as [F, rows, width], a copy per fold."""
    return torch.from_numpy(np.ascontiguousarray(
        np.broadcast_to(a, (n_folds,) + a.shape))).to(device)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument('-R', '--dataset_resourse', type=str, default='ADNI')
    parser.add_argument('-H', '--hz_para_list', nargs='+', type=int,
                        default=[110, 110, 10])
    parser.add_argument('-C', '--combine', type=str, default='gpoe')
    parser.add_argument('-P', '--procedure', type=str, default='UCA-gPoE')
    parser.add_argument('-E', '--epochs', type=int, default=500)
    parser.add_argument('-K', '--n_splits', type=int, default=5)
    parser.add_argument('--batch_size', type=int, default=128)
    parser.add_argument('-BaseLR', '--base_learning_rate', type=float,
                        default=0.0001)
    common.add_variant_flags(parser, ['packed_xla', 'mesh'])
    return parser


def run(argv=None, project_root=None):
    return train_and_test(build_parser().parse_args(argv),
                          project_root=project_root)


if __name__ == '__main__':
    run()
