"""End-to-end supervised variant, nm-PM-cont (counterpart of
cli/nmpmcont.py).

Trains the dual-decoder contrastive + classifier model (models/endtoend.py)
for every fold at once, classifies each fold's test rows in eval mode and
appends the per-metric mean and std lines to results_endtoend.csv. Writes
the JAX CLI's files: the fold id CSVs, per fold ``NNN/cVAE_model.{ckpt,json}``
(the flax msgpack format) and ``NNN/Lossestraining.png`` (needs
matplotlib), and results_endtoend.csv.

Reference quirks kept, as the JAX CLI keeps them:
  * fold ids are generated into outputs/kfold_analysis_endtoend
    (nmpmcont:167) but read from outputs/kfold_analysis (nmpmcont:170-171),
    falling back to the endtoend dir (with a note) when the main dir has no
    ids;
  * -Weightkl and -Weightrec are parsed but unused: the loss takes only the
    margin and the contrastive weight (nmpmcont:298), the KL and
    reconstruction weights stay 0.1 (cVAE.py:2140);
  * -Dropout and -Learningrateclassifier are parsed but unused: dropout 0.5
    (nmpmcont:267), one learning rate;
  * the cyclic LR assignment is a no-op (SURVEY.md Q1): constant 1e-4;
  * with -P SingleModality-*, -SingleModality is set after parsing
    (nmpmcont:463-470).

The classification of the test rows is ``EndToEndCVAE.predict``: on CUDA
each modality's encoder is one launch of the encoder kernel for every
fold, PoE and the classifier head in torch.

    python -m multi_modal_normative_modeling_tpu_torch.cli.nmpmcont \\
        -R ADNI -P SE-MoE -E 200 -K 5 [-Layers 128 64 32] [--device cpu]
        [--checkpoint_every N [--resume]]
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
from ..data.preprocess import (
    binary_labels,
    fit_robust_scaler,
    one_hot_covariates,
)
from ..evaluation.metrics import binary_prediction_metrics
from ..evaluation.reports import append_endtoend_results
from ..interop import params_to_jax
from ..models.endtoend import EndToEndCVAE, endtoend_loss_fn
from ..parallel import MultiFoldTrainer, stack_fold_batches
from ..train import TrainConfig
from . import common


def default_init(model: EndToEndCVAE) -> None:
    """One fold drawn from torch.Generator seeded 42, repeated over the
    folds (the reference re-seeds 42 per fold, nmpmcont:174-177)."""
    common.init_from_one_fold(model, EndToEndCVAE(
        model.input_dim_list, model.hidden_dim, model.latent_dim,
        model.c_dim, model.modalities, model.non_linear,
        model.classifier_layers, model.dropout_rate, model.num_classes,
        folds=1, generator=torch.Generator().manual_seed(42)))


def _prep_fold(project_root, resource, names, participants_path,
               train_ids, test_ids, hc_label, read):
    """Scale, one-hot covariates and binary labels of one fold, every
    modality (nmpmcont:75-123)."""
    out = {'train_data': [], 'train_cov': [], 'test_data': [],
           'test_cov': []}
    train_frames, test_frames = [], []
    for name in names:
        columns = registry.get_column_name(resource, name)
        path = Path(project_root) / 'data' / resource / f'{name}.csv'
        train_df = common.load_dataset(participants_path, train_ids, path,
                                       read)
        test_df = common.load_dataset(participants_path, test_ids, path, read)
        data, scaler = fit_robust_scaler(train_df[columns].values)
        out['train_data'].append(data.astype(np.float32))
        out['train_cov'].append(
            one_hot_covariates(train_df[['DIA', 'PTGENDER', 'AGE']]))
        out['test_data'].append(
            scaler.transform(test_df[columns].values).astype(np.float32))
        out['test_cov'].append(
            one_hot_covariates(test_df[['DIA', 'PTGENDER', 'AGE']]))
        out['train_labels'] = binary_labels(train_df['DIA'], hc_label)
        out['test_labels'] = binary_labels(test_df['DIA'], hc_label)
        train_frames.append(train_df)
        test_frames.append(test_df)
    return out, train_frames, test_frames


def prepare_cohort(args, project_root: Path, walls: common.StageWalls):
    """The fold ids (written to outputs/kfold_analysis_endtoend, read from
    outputs/kfold_analysis when it holds ids) and every fold's data
    (``_prep_fold``): (fold_data, input_dim_list, c_dim), under the 'data'
    wall. Shared with the end-to-end sweep."""
    output_dir = project_root / 'outputs'
    kfold_dir = output_dir / 'kfold_analysis'
    kfold_dir.mkdir(parents=True, exist_ok=True)

    np.random.seed(42)
    names = registry.get_datasets_name(args.dataset_resourse, args.procedure)
    participants_path = project_root / 'data' / args.dataset_resourse / 'y.csv'
    ids_df = pd.read_csv(participants_path)
    hc_label = registry.get_hc_label(args.dataset_resourse)

    with walls('data'):
        common.generate_kfold_ids_endtoend(
            ids_df[ids_df['DIA'] == hc_label],
            ids_df[ids_df['DIA'] != hc_label],
            oversample_percentage=args.oversample_percentage,
            n_splits=args.n_splits, project_root=project_root)
        ids_source = kfold_dir
        if not (kfold_dir / 'train_ids_000.csv').exists():
            ids_source = output_dir / 'kfold_analysis_endtoend'
            print('note: no ids in kfold_analysis, using '
                  'kfold_analysis_endtoend')
        n_folds = args.n_splits
        with ThreadPoolExecutor(max_workers=8) as pool:
            read = common.shared_tables(pool, project_root,
                                        args.dataset_resourse, names,
                                        participants_path)
            preps = list(pool.map(lambda fold: _prep_fold(
                project_root, args.dataset_resourse, names,
                participants_path, *common.fold_paths(ids_source, fold),
                hc_label, read), range(n_folds)))
        fold_data = []
        for fold, (prep, train_frames, test_frames) in enumerate(preps):
            common.assert_modalities_aligned(train_frames,
                                             f'nmpmcont train fold {fold}')
            common.assert_modalities_aligned(test_frames,
                                             f'nmpmcont test fold {fold}')
            fold_data.append(prep)
        input_dim_list = [d.shape[1] for d in fold_data[0]['train_data']]
        c_dim = fold_data[0]['train_cov'][0].shape[1]
    return fold_data, input_dim_list, c_dim


def fold_batches(fold_data, batch_size: int) -> dict:
    """Every fold's training batches, the binary labels as an extra."""
    return stack_fold_batches(
        [f['train_data'] for f in fold_data],
        [f['train_cov'] for f in fold_data], batch_size,
        extras=[{'labels': f['train_labels'].astype(np.float32)[:, None]}
                for f in fold_data])


def test_inputs(fold_data, modalities: int, device, repeats: int = 1):
    """Every fold's test rows and covariates padded to the scoring bucket,
    (xes, cs, rows): one [repeats * F, rows, width] tensor per modality,
    the folds repeated ``repeats`` times along the fold axis (a sweep's
    configs, config-major)."""
    rows = common.padded_rows(max(f['test_data'][0].shape[0]
                                  for f in fold_data))
    folds = list(fold_data) * repeats
    xes = [common.stack_padded([f['test_data'][m] for f in folds], rows,
                               device) for m in range(modalities)]
    cs = [common.stack_padded([f['test_cov'][m] for f in folds], rows,
                              device) for m in range(modalities)]
    return xes, cs, rows


def fold_metrics(fold_data, logits: np.ndarray,
                 verbose: bool = False) -> pd.DataFrame:
    """The binary prediction metrics of every fold from its test rows'
    logits [F, rows, 2] (argmax, padding rows dropped), one row a fold."""
    all_metrics = []
    for fold, data in enumerate(fold_data):
        n_rows = data['test_data'][0].shape[0]
        preds = np.argmax(logits[fold, :n_rows], axis=1)
        metrics = binary_prediction_metrics(data['test_labels'], preds)
        if verbose:
            print(f'Fold {fold} metrics:')
            print(metrics)
        all_metrics.append(metrics)
    return pd.DataFrame(all_metrics)


def main(args, project_root=None, init_fn: Optional[common.InitFn] = None,
         draws_fn: Optional[common.DrawsFn] = None,
         timings: Optional[dict] = None):
    """``init_fn(model)`` fills the fold-stacked model's initial weights
    (default ``default_init``); ``draws_fn`` gives every training step's
    noise and dropout keep masks (tests replay the JAX package's); by
    default every fold draws from its own generator on the device.
    ``timings``, when given, receives the stages' walls, the training
    steps and the trainer's seconds. Returns the per-fold metrics."""
    common.refuse_not_ported(args, 'end-to-end trainer')
    common.require_checkpoint_for_resume(args)
    device = common.resolve_device(getattr(args, 'device', 'cuda'), 'train')
    timings = {} if timings is None else timings
    walls = common.StageWalls(timings.setdefault('walls', {}))
    project_root = Path(project_root) if project_root else Path.cwd()
    model_dir = project_root / 'outputs' / 'kfold_analysis' / 'supervised_cvae'
    modalities = len(registry.get_datasets_name(args.dataset_resourse,
                                                args.procedure))
    fold_data, input_dim_list, c_dim = prepare_cohort(args, project_root,
                                                      walls)
    n_folds = len(fold_data)
    for fold in range(n_folds):
        (model_dir / f'{fold:03d}').mkdir(parents=True, exist_ok=True)

    h_dim, z_dim = args.hz_para_list[:-1], args.hz_para_list[-1]
    model = EndToEndCVAE(input_dim_list, h_dim, z_dim, c_dim, modalities,
                         non_linear=True, classifier_layers=args.layers,
                         dropout_rate=0.5, num_classes=2, folds=n_folds)
    (init_fn or default_init)(model)
    model.to(device)
    config = TrainConfig(epochs=args.epochs, batch_size=256,
                         learning_rate=0.0001, combine='poe', shuffle=False,
                         seed=42)
    resumable = common.Resumable(args)
    with walls('train'):
        batches = fold_batches(fold_data, config.batch_size)
        draws = {}
        if draws_fn is not None:
            draws = draws_fn(batches['valid'], config.epochs,
                             config.batch_size, model)
        trainer = MultiFoldTrainer(
            model, config, max(f['train_data'][0].shape[0]
                               for f in fold_data),
            loss_fn=endtoend_loss_fn(model, args.margin,
                                     args.weightcontrastive),
            state_update=model.update_state)
        print('train model (all folds fold-parallel)')
        start = time.perf_counter()
        # one whole-run train state in the model dir (the JAX CLI keeps
        # one per fold, or one per packed layout)
        logs = resumable.run(trainer, batches, state_dir=model_dir, **draws)
        timings['train_run_s'] = time.perf_counter() - start
        timings['train_steps'] = ((config.epochs - resumable.resumed_from)
                                  * batches['mask'].shape[1])

    with walls('score'):
        xes, cs, rows = test_inputs(fold_data, modalities, device)
        all_logits = model.predict(xes, cs).cpu().numpy()
        timings['score_rows'] = rows

    with walls('write'):
        common.emit_fold_artifacts(
            model_dir, [{k: v[f] for k, v in logs.items()}
                        for f in range(n_folds)],
            [params_to_jax(model, fold=f) for f in range(n_folds)], {
                'model': 'cVAE_multimodal_endtoend',
                'input_dim_list': list(map(int, input_dim_list)),
                'hidden_dim': list(h_dim), 'latent_dim': int(z_dim),
                'c_dim': int(c_dim), 'modalities': modalities,
                'classifier_layers': list(args.layers),
            }, n_folds)
        all_metrics_df = fold_metrics(fold_data, all_logits, verbose=True)
        print(all_metrics_df.mean())
        print(all_metrics_df.std())
        append_endtoend_results(project_root / 'results_endtoend.csv', args,
                                all_metrics_df)
    walls.report('nmpmcont')
    return all_metrics_df


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    common.add_common_flags(parser, default_n_splits=5)
    parser.add_argument('-Learningrateclassifier', '--learning_rate_classifier',
                        dest='learning_rate_classifier', type=float,
                        default=0.001, help='Learning rate for the classifier.')
    parser.add_argument('-Margin', '--margin', dest='margin', type=float,
                        default=1, help='Margin for the contrastive loss.')
    parser.add_argument('-Weightcontrastive', '--weightcontrastive',
                        dest='weightcontrastive', type=float, default=1,
                        help='weight for the contrastive loss.')
    parser.add_argument('-Weightkl', '--weight_kl', dest='weight_kl',
                        type=float, default=1,
                        help='Weight for the kl divergence loss.')
    parser.add_argument('-Weightrec', '--weight_rec', dest='weight_rec',
                        type=float, default=1,
                        help='Weight for the reconstruction loss.')
    parser.add_argument('-Dropout', '--dropout', dest='dropout', type=float,
                        default=0.5, help='Dropout rate for the classifier.')
    parser.add_argument('-Layers', '--layers', dest='layers', nargs='+',
                        default=[128, 64, 32], type=int,
                        help='Layers for the classifier.')
    common.add_variant_flags(parser, ['packed_xla', 'ep_mesh', 'mesh'])
    return parser


def run(argv=None, project_root=None):
    args = build_parser().parse_args(argv)
    common.apply_post_parse_defaults(args, default_procedure='SE-MoE')
    # reference post-parse quirk (nmpmcont:463-470)
    if args.procedure.startswith('SingleModality'):
        if args.dataset_resourse == 'ADNI':
            args.single_modality = 'av45'
        elif args.dataset_resourse == 'HCP':
            args.single_modality = 'T1_volume'
        else:
            raise ValueError('Unknown dataset resource')
    return main(args, project_root=project_root)


if __name__ == '__main__':
    run()
