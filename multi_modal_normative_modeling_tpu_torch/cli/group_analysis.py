"""Deviation -> classification group analysis (counterpart of
cli/group_analysis.py).

Drop-in CLI for multimodal_kfold_cvae_group_analysis_1x1.py: averages the
per-modality reconstruction_error CSVs per fold, computes ROC/Youden metrics
per hc/disease label pair, and appends the result_baseline reports +
cvae_auc_and_std.csv / auc_rocs.csv artifacts. Host code only: numpy and
pandas, no torch tensor and no scikit-learn (``evaluation.metrics``).

    python -m multi_modal_normative_modeling_tpu_torch.cli.group_analysis \\
        -R ADNI -P UCA-gPoE -K 5 [--threshold_method roc|f1|pr|cost|eer]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import pandas as pd

from .. import registry
from ..evaluation.metrics import classification_performance
from ..evaluation.reports import (
    append_result_4,
    append_result_multimodal,
    write_auc_csvs,
)
from . import common


def _fold_frames(args, project_root: Path, dataset_names):
    """Per-fold (averaged error frame, DIA-labeled test frame), shared by
    every hc/disease pair (the reference recomputes these merges per pair
    AND per modality, group_analysis:197-215, though only the LAST
    modality's merge survives its loop — we load just that one)."""
    model_name = 'supervised_cvae'
    participants_path = project_root / 'data' / args.dataset_resourse / 'y.csv'
    kfold_dir = project_root / 'outputs' / 'kfold_analysis'
    model_dir = kfold_dir / model_name

    frames = []
    # last modality wins in the reference's per-modality merge loop — but
    # its merge only supplies per-subject DIA labels (rows align by the
    # participant_id index), so when the last modality's CSV was never
    # materialized (--in_memory_fusion skips the early-fusion CSV) any
    # existing base modality gives the identical frame
    data_dir = project_root / 'data' / args.dataset_resourse
    modality_path = data_dir / f'{dataset_names[-1]}.csv'
    if not modality_path.exists():
        for name in reversed(dataset_names[:-1]):
            candidate = data_dir / f'{name}.csv'
            if candidate.exists():
                modality_path = candidate
                break
    # every fold merges the same two tables: parse each once
    tables = {path: common.read_csv(path)
              for path in (participants_path, modality_path)}
    for fold in range(args.n_splits):
        _, test_ids_path = common.fold_paths(kfold_dir, fold)
        fold_model_dir = model_dir / f'{fold:03d}'
        # last modality wins in the reference's per-modality merge loop
        test_dataset_df = common.load_dataset(
            participants_path, test_ids_path, modality_path,
            read=tables.__getitem__)
        test_dataset_df = test_dataset_df.set_index('participant_id')
        error_frames = [
            pd.read_csv(fold_model_dir / name /
                        f'reconstruction_error_{name}.csv',
                        index_col='participant_id')
            for name in dataset_names
        ]
        averaged = error_frames[0]
        for frame in error_frames[1:]:
            averaged = averaged + frame
        averaged = averaged / len(error_frames)
        frames.append((averaged, test_dataset_df))
    return frames


def analyze_pair(args, project_root: Path, fold_frames=None):
    """One hc/disease label pair (group_analysis main(), :162-267)."""
    kfold_dir = project_root / 'outputs' / 'kfold_analysis'

    auc_roc_list, accuracy_list = [], []
    sensitivity_list, specificity_list = [], []

    dataset_names = registry.get_datasets_name(args.dataset_resourse,
                                               args.procedure)
    if args.combine is None:
        raise ValueError(f'Unknown procedure: {args.procedure}')

    dataset_name = dataset_names[-1]
    if fold_frames is None:
        fold_frames = _fold_frames(args, project_root, dataset_names)

    for averaged, test_dataset_df in fold_frames:
        error_hc = averaged.loc[
            test_dataset_df['DIA'] == args.hc_label]['Reconstruction error']
        error_patient = averaged.loc[
            test_dataset_df['DIA'] == args.disease_label]['Reconstruction error']

        # the per-fold significance returned here is recomputed below as
        # auc/(1-auc) over the whole list (reference behavior) — only the
        # first four outputs feed the reports
        roc_auc, accuracy, recall, specificity, _ = (
            classification_performance(
                error_hc, error_patient, args.training_class,
                method=getattr(args, 'threshold_method', 'roc'))
        )
        auc_roc_list.append(roc_auc)
        accuracy_list.append(accuracy)
        sensitivity_list.append(recall)
        specificity_list.append(specificity)

    comparison_dir = (kfold_dir / dataset_name /
                      f'{args.hc_label:02d}_vs_{args.disease_label:02d}')
    comparison_dir.mkdir(parents=True, exist_ok=True)

    auc_roc_arr = np.array(auc_roc_list)
    significance_ratio_arr = auc_roc_arr / (1 - auc_roc_arr)
    compare_name = (f"{args.dataset_resourse}: "
                    f"{args.hc_label} vs {args.disease_label}")

    append_result_multimodal(project_root / 'result_baseline', compare_name,
                             args, auc_roc_arr, accuracy_list,
                             sensitivity_list, specificity_list,
                             significance_ratio_arr)
    write_auc_csvs(project_root, comparison_dir, auc_roc_arr)

    return (np.mean(auc_roc_arr), np.std(auc_roc_arr),
            np.mean(accuracy_list), np.std(accuracy_list),
            np.mean(sensitivity_list), np.std(sensitivity_list),
            np.mean(specificity_list), np.std(specificity_list),
            np.mean(significance_ratio_arr), np.std(significance_ratio_arr))


def main(args, project_root=None):
    project_root = Path(project_root) if project_root else Path.cwd()
    pairs = registry.HC_PATIENT_COMBINATIONS[args.dataset_resourse]

    stats = {k: [] for k in ('auc', 'auc_std', 'acc', 'acc_std', 'rec',
                             'rec_std', 'spec', 'spec_std', 'sig', 'sig_std')}
    dataset_names = registry.get_datasets_name(args.dataset_resourse,
                                               args.procedure)
    fold_frames = _fold_frames(args, project_root, dataset_names)
    for hc_label, disease_label in pairs:
        args.hc_label = hc_label
        args.disease_label = disease_label
        results = analyze_pair(args, project_root, fold_frames=fold_frames)
        for key, value in zip(stats.keys(), results):
            stats[key].append(value)

    append_result_4(project_root / 'result_baseline', args,
                    stats['auc'], stats['auc_std'], stats['acc'],
                    stats['acc_std'], stats['rec'], stats['rec_std'],
                    stats['spec'], stats['spec_std'], stats['sig'],
                    stats['sig_std'])
    return stats


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    common.add_common_flags(parser)
    parser.add_argument('--threshold_method', dest='threshold_method',
                        default='roc',
                        choices=['roc', 'f1', 'pr', 'cost', 'eer'],
                        help="optimal-threshold finder (the reference ships "
                             "all five but hardcodes 'roc', "
                             "group_analysis:220,353).")
    return parser


def run(argv=None, project_root=None):
    args = build_parser().parse_args(argv)
    common.apply_post_parse_defaults(args)
    return main(args, project_root=project_root)


if __name__ == '__main__':
    run()
