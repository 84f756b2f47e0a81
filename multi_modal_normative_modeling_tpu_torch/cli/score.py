"""Batch deviation scoring of new subjects (counterpart of cli/score.py).

Loads the trained fold checkpoints and scores an arbitrary subject list
(an ids CSV) against the normative model: per-subject deviation scores and
per-ROI deviations, ensembled over all folds (the mean over fold models)
or from one fold (``--fold``).

Scalers are refit from each fold's train ids (the reference's convention,
multimodal_kfold_test_cvae_supervised.py:82-90), and covariates are binned
by each fold's train cohort (data/preprocess.train_binned_covariates), so
a subject's score does not depend on who else is in the ids CSV. The
experiment directory must hold outputs/kfold_analysis/train_ids_*.csv and
the fold checkpoints.

Every requested fold is scored by one call on a fold-stacked model
(infer/ensemble.reconstruct): on CUDA one K1 and one K2 launch per
modality, each covering every fold, and a launch that fails raises. Fold
f's noise is one [padded rows, Z] draw seeded ``--seed`` + f. As in the JAX
CLI, a fold's deviation is the modality mean of the float32 device
deviations, and the ROI plane is computed on the host from the float64
scaled data and the float32 reconstruction. ``--latent`` adds the latent
z-scores against each fold's train cohort (two more K1 launches per
modality: the train cohorts and the subjects).

    python -m multi_modal_normative_modeling_tpu_torch.cli.score \
        -R ADNI -P UCA-gPoE -K 5 --ids ids.csv --roi_output roi.csv --latent
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

import numpy as np
import pandas as pd

from .. import registry
from ..data.preprocess import train_binned_covariates
from ..infer.emitters import write_csv
from ..infer.ensemble import (EpsFn, fold_eps, latent_zscores, reconstruct,
                              resolve_combine, train_latent_stats)
from ..train.checkpoints import checkpoint_exists
from . import common

_NOT_PORTED_FLAGS = {'mesh': "queue 1 item 'Multi-device'"}


def score(args, project_root=None,
          eps_fn: Optional[EpsFn] = None) -> pd.DataFrame:
    common.refuse_not_ported(args, 'score CLI', _NOT_PORTED_FLAGS)
    device = common.resolve_device(getattr(args, 'device', 'cuda'), 'score')
    project_root = Path(project_root) if project_root else Path.cwd()
    kfold_dir = project_root / 'outputs' / 'kfold_analysis'
    model_dir = kfold_dir / 'supervised_cvae'
    participants_path = project_root / 'data' / args.dataset_resourse / 'y.csv'
    dataset_names = registry.get_datasets_name(args.dataset_resourse,
                                               args.procedure)
    n_mod = len(dataset_names)
    folds = list(range(args.n_splits) if args.fold is None else [args.fold])
    emit_latent = getattr(args, 'latent', False)
    for fold in folds:
        if not checkpoint_exists(model_dir / f'{fold:03d}'):
            raise FileNotFoundError(
                f'no checkpoint in {model_dir / f"{fold:03d}"}; train first')

    fold_preps = common.prepare_fold_modalities(
        project_root, args.dataset_resourse, dataset_names, participants_path,
        [(common.fold_paths(kfold_dir, fold)[0], args.ids) for fold in folds])
    covs = []
    for fold, fp in zip(folds, fold_preps):
        common.assert_modalities_aligned([p['test_df'] for p in fp],
                                         f'score fold {fold}')
        # serving covariates: train-quantile binning, NOT the k-fold
        # test-split re-binning (which would make a subject's score depend
        # on the rest of the ids CSV and break for 1 subject). Frames are
        # aligned, so one modality's demographics stand for all (the last
        # modality, the reference's test:102 convention)
        covs.append(train_binned_covariates(
            fp[-1]['train_df'][['AGE', 'PTGENDER']],
            fp[-1]['test_df'][['AGE', 'PTGENDER']]))
    subject_ids = fold_preps[0][-1]['test_df']['participant_id'].values
    columns_list = [p['columns'] for p in fold_preps[0]]

    model, _, config = common.load_model_and_params(
        [model_dir / f'{fold:03d}' for fold in folds], device)
    combine = resolve_combine(args.combine, config, args.procedure)
    if emit_latent and not hasattr(model, 'latent_stats_fused'):
        raise SystemExit(f"--latent: model variant "
                         f"{config.get('variant', 'cvae')!r} has no "
                         'deterministic fused latent')

    # one call over the stacked folds, every fold's rows padded to one
    # bucket (rows are independent through the model)
    n_rows = len(subject_ids)
    padded = common.padded_rows(n_rows)
    data = [[p['test_data'] for p in fp] for fp in fold_preps]
    xes = [common.stack_padded([d[m] for d in data], padded, device)
           for m in range(n_mod)]
    c = common.stack_padded(covs, padded, device)
    eps = fold_eps([args.seed + fold for fold in folds], padded,
                   model.noise_dim, device, eps_fn)
    recons, devs = reconstruct(model, xes, [c] * n_mod, combine, eps)
    recons = [r[:, :n_rows].cpu().numpy() for r in recons]
    devs = devs[:, :, :n_rows].cpu().numpy()               # [K, M, N]
    per_fold_dev = devs.mean(axis=1)
    per_fold_roi = [
        np.concatenate([(d[m] - recons[m][i]) ** 2 for m in range(n_mod)],
                       axis=1) for i, d in enumerate(data)]

    out = pd.DataFrame({'participant_id': subject_ids,
                        'deviation': np.mean(per_fold_dev, axis=0)})
    if emit_latent:
        # z-scores against each fold's (oversampled) train cohort
        # (utils_vae.py:155-157; deterministic, no sampling)
        latent, _ = latent_zscores(
            model, combine, xes, [c] * n_mod,
            *train_latent_stats(model, combine, fold_preps))
        out['latent_deviation'] = latent[:, :n_rows].cpu().numpy().mean(
            axis=0)
    if args.output:
        out.to_csv(args.output, index=False)
        if args.roi_output:
            # modality-suffixed names: ADHD/UCA modalities share raw ROI
            # names, which would collide into duplicate CSV headers
            all_cols = [f'{col}_{name}' for cols, name
                        in zip(columns_list, dataset_names) for col in cols]
            roi_frame = pd.DataFrame(np.mean(per_fold_roi, axis=0),
                                     columns=all_cols)
            roi_frame.insert(0, 'participant_id', subject_ids)
            write_csv(args.roi_output, roi_frame)
        print(f'scored {len(out)} subjects '
              f'({"ensemble of " + str(len(folds)) + " folds" if args.fold is None else f"fold {args.fold}"}) '
              f'-> {args.output}')
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='Score subjects against a trained normative model.')
    parser.add_argument('-R', '--dataset_resourse', type=str, default='ADNI')
    parser.add_argument('-P', '--procedure', type=str, default='UCA-gPoE')
    parser.add_argument('-C', '--combine', type=str, default=None)
    parser.add_argument('-K', '--n_splits', type=int, default=10)
    parser.add_argument('--ids', required=True,
                        help='CSV with an IID column listing subjects to '
                             'score (must exist in the modality tables).')
    parser.add_argument('--fold', type=int, default=None,
                        help='score with one fold model instead of the '
                             'all-fold ensemble.')
    parser.add_argument('--output', default='deviation_scores.csv')
    parser.add_argument('--roi_output', default=None,
                        help='also write per-ROI squared deviations here.')
    parser.add_argument('--latent', action='store_true',
                        help='add a latent_deviation column (latent '
                             'z-scores against each fold train cohort, '
                             'utils_vae.py:155-157 semantics).')
    parser.add_argument('--seed', type=int, default=42)
    parser.add_argument('--device', default='cuda',
                        help='torch device to score on (default cuda); cuda '
                             'runs the kernels, cpu their plain versions')
    parser.add_argument('--mesh', default=None, metavar='F,D',
                        help='not ported yet (raises); see ROADMAP.md')
    return parser


def run(argv=None, project_root=None, eps_fn: Optional[EpsFn] = None):
    args = build_parser().parse_args(argv)
    # combine resolution happens in score() once the checkpoint config is
    # in hand (infer.ensemble.resolve_combine: config beats the
    # procedure-suffix heuristic, which is wrong for SM-* procedures)
    return score(args, project_root=project_root, eps_fn=eps_fn)


if __name__ == '__main__':
    run()
