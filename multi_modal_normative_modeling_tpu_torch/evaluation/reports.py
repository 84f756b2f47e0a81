"""Append-only result report writers, bit-compatible with the reference's
text/CSV artifacts:

  * result_baseline/result_multimodal.txt  (group_analysis:247-258)
  * result_baseline/result_4.txt           (group_analysis:373-381)
  * cvae_auc_and_std.csv                   (group_analysis:259)
  * <comparison_dir>/auc_rocs.csv          (group_analysis:260-261)
  * results_endtoend.csv                   (nmpmcont:330-338)
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import pandas as pd


def append_result_multimodal(result_dir, compare_name: str, args,
                             auc_roc_list, accuracy_list, sensitivity_list,
                             specificity_list, significance_ratio_list) -> None:
    result_dir = Path(result_dir)
    result_dir.mkdir(parents=True, exist_ok=True)
    with open(result_dir / "result_multimodal.txt", "a") as f:
        f.write(
            'Experiment settings: CVAE. {}. Procedure {} Epochs {} Oversample '
            'percentage {}\n args.Model {} args.hz_para_list {}\n'.format(
                compare_name, args.procedure, args.epochs,
                args.oversample_percentage, args.model, args.hz_para_list)
        )
        f.write('ROC-AUC: $ {:0.2f} \\pm {:0.2f} $ \n'.format(
            np.mean(auc_roc_list) * 100, np.std(auc_roc_list) * 100))
        f.write('Accuracy: $ {:0.2f} \\pm {:0.2f} $ \n'.format(
            np.mean(accuracy_list) * 100, np.std(accuracy_list) * 100))
        f.write('Sensitivity: $ {:0.2f} \\pm {:0.2f} $ \n'.format(
            np.mean(sensitivity_list) * 100, np.std(sensitivity_list) * 100))
        f.write('Specificity: $ {:0.2f} \\pm {:0.2f} $ \n'.format(
            np.mean(specificity_list) * 100, np.std(specificity_list) * 100))
        f.write('Significance ratio: $ {:0.2f} \\pm {:0.2f} $ \n'.format(
            np.mean(significance_ratio_list), np.std(significance_ratio_list)))
        f.write('hz_para_list: ' + str(args.hz_para_list) + '\n')
        f.write('\n\n\n')


def parse_result_auc(project_root, compare_fragment: str = "2 vs 0"):
    """Pooled (AUC, std) from a result_multimodal.txt block — the inverse
    of append_result_multimodal's ROC-AUC line, percent downscaled. ONE
    owner for the parse used by scripts/baseline_probe.py and
    scripts/quality_fast_recipe.py (``compare_fragment`` picks the
    comparison block, e.g. '2 vs 0' = HC vs AD on ADNI)."""
    import re

    text = (Path(project_root) / "result_baseline" /
            "result_multimodal.txt").read_text()
    for block in text.split("Experiment settings"):
        if compare_fragment in block:
            m = re.search(r"ROC-AUC: \$ ([0-9.]+) \\pm ([0-9.]+) \$", block)
            if m:
                return (round(float(m.group(1)) / 100, 4),
                        round(float(m.group(2)) / 100, 4))
    raise RuntimeError(f"no {compare_fragment!r} block found")


def append_result_4(result_dir, args, mean_auc_roc_list, std_auc_roc_list,
                    mean_accuracy_list, std_accuracy_list, mean_recall_list,
                    std_recall_list, mean_specificity_list,
                    std_specificity_list, mean_significance_ratio_list,
                    std_significance_ratio_list) -> None:
    result_dir = Path(result_dir)
    result_dir.mkdir(parents=True, exist_ok=True)
    with open(result_dir / "result_4.txt", "a") as f:
        f.write(
            'Experiment settings: CVAE. {}. Procedure {} Epochs {} Oversample '
            'percentage {}\n'.format('HC vs AD, HC vs MCI, MCI vs AD',
                                     args.procedure, args.epochs,
                                     args.oversample_percentage)
        )
        f.write('ROC-AUC: $ {:0.2f} \\pm {:0.2f} $ \n'.format(
            np.mean(mean_auc_roc_list) * 100, np.mean(std_auc_roc_list) * 100))
        f.write('Accuracy: $ {:0.2f} \\pm {:0.2f} $ \n'.format(
            np.mean(mean_accuracy_list) * 100, np.mean(std_accuracy_list) * 100))
        f.write('Sensitivity: $ {:0.2f} \\pm {:0.2f} $ \n'.format(
            np.mean(mean_recall_list) * 100, np.mean(std_recall_list) * 100))
        f.write('Specificity: $ {:0.2f} \\pm {:0.2f} $ \n'.format(
            np.mean(mean_specificity_list) * 100,
            np.mean(std_specificity_list) * 100))
        f.write('Significance ratio: $ {:0.2f} \\pm {:0.2f} $ \n'.format(
            np.mean(mean_significance_ratio_list),
            np.mean(std_significance_ratio_list)))
        f.write('hz_para_list: ' + str(args.hz_para_list) + '\n')
        f.write('\n\n\n')


def write_auc_csvs(project_root, comparison_dir, auc_roc_list) -> None:
    """cvae_auc_and_std.csv (per-fold AUCs + trailing std, np.savetxt layout)
    and <comparison_dir>/auc_rocs.csv."""
    auc_roc_list = np.asarray(auc_roc_list, dtype=float)
    np.savetxt(os.path.join(str(project_root), "cvae_auc_and_std.csv"),
               np.concatenate((auc_roc_list, [np.std(auc_roc_list)])),
               delimiter=",")
    comparison_dir = Path(comparison_dir)
    comparison_dir.mkdir(parents=True, exist_ok=True)
    pd.DataFrame(columns=["ROC-AUC"], data=auc_roc_list).to_csv(
        comparison_dir / "auc_rocs.csv", index=False
    )


def append_endtoend_results(results_path, args, all_metrics_df: pd.DataFrame
                            ) -> None:
    """Append args + per-metric '$mean \\pm std$' lines (nmpmcont:330-338)."""
    with open(results_path, "a") as f:
        f.write(str(args) + "\n")
        means = all_metrics_df.mean()
        stds = all_metrics_df.std()
        for metric in means.index:
            f.write(f"{metric} ${means[metric]:.3f} \\pm {stds[metric]:.3f}$\n")
        f.write("\n\n\n")


def append_performance_metrics(results_dir, mean_auc, std_auc, mean_accuracy,
                               std_accuracy, mean_sensitivity, std_sensitivity,
                               mean_specificity, std_specificity,
                               mean_significance_ratio,
                               std_significance_ratio) -> None:
    """nm-MLP analyze() report (nmmlp:637-643)."""
    results_dir = Path(results_dir)
    results_dir.mkdir(parents=True, exist_ok=True)
    with open(results_dir / "performance_metrics.txt", "a") as f:
        f.write("Overall Performance:\n")
        f.write(f"Mean ROC AUC: {mean_auc:.4f} ± {std_auc:.4f}\n")
        f.write(f"Mean Accuracy: {mean_accuracy:.4f} ± {std_accuracy:.4f}\n")
        f.write(
            f"Mean Sensitivity: {mean_sensitivity:.4f} ± {std_sensitivity:.4f}\n"
        )
        f.write(
            f"Mean Specificity: {mean_specificity:.4f} ± {std_specificity:.4f}\n"
        )
        f.write(
            "Mean Significance Ratio: "
            f"{mean_significance_ratio:.4f} ± {std_significance_ratio:.4f}\n"
        )
