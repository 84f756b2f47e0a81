"""Experiment report generator (counterpart of cli/report.py).

Collects an experiment directory's artifacts (result_baseline texts,
cvae_auc_and_std.csv, per-fold deviation CSVs) into one markdown report with
AUC tables and top-ROI deviation effect sizes — the human-readable rollup the
reference leaves scattered across append-only text files. It reads the
files the port's chain writes, which are the JAX package's, and writes the
same markdown (tests/test_torch_report.py).

    python -m multi_modal_normative_modeling_tpu_torch.cli.report \
        -R ADNI -P UCA-gPoE [--out experiment_report.md]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .. import registry


def generate_report(project_root, resource: str, procedure: str,
                    out_path=None) -> str:
    project_root = Path(project_root)
    lines = [f"# Experiment report — {resource} / {procedure}", ""]

    auc_csv = project_root / "cvae_auc_and_std.csv"
    if auc_csv.exists():
        values = np.loadtxt(auc_csv, delimiter=",")
        folds, std = values[:-1], values[-1]
        lines += [
            "## Deviation-score classification (last analysis run)",
            "",
            f"- mean ROC-AUC: **{folds.mean():.4f} ± {std:.4f}** "
            f"({len(folds)} folds)",
            "- per-fold: " + ", ".join(f"{v:.3f}" for v in folds),
            "",
        ]

    result_txt = project_root / "result_baseline" / "result_multimodal.txt"
    if result_txt.exists():
        blocks = [b for b in result_txt.read_text().split("\n\n\n") if b.strip()]
        if blocks:  # an empty/truncated file skips the section, not crashes
            lines += ["## result_multimodal.txt (latest block)", "",
                      "```", blocks[-1].strip(), "```", ""]

    dev_root = (project_root / "deviation" / "supervised_cvae" / resource /
                procedure / "path_model")
    if dev_root.exists():
        from ..viz import roi_deviation_table

        hc = registry.get_hc_label(resource)
        lines += ["## Top deviating ROIs (patient vs HC, Cohen's d)", ""]
        for mod_dir in sorted(dev_root.iterdir()):
            roi_csv = mod_dir / f"reconstruction_error_roi_{mod_dir.name}.csv"
            if not roi_csv.exists():
                continue
            table = roi_deviation_table(roi_csv, hc, top_k=5)
            lines.append(f"### {mod_dir.name}")
            lines.append("")
            lines.append("| ROI | HC mean dev | patient mean dev | d |")
            lines.append("|---|---|---|---|")
            for _, row in table.iterrows():
                lines.append(
                    f"| {row['roi']} | {row['hc_mean_dev']:.4f} | "
                    f"{row['patient_mean_dev']:.4f} | {row['cohens_d']:.2f} |")
            lines.append("")

    report = "\n".join(lines)
    if out_path:
        Path(out_path).write_text(report)
    return report


def run(argv=None, project_root=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-R", "--dataset_resourse", default="ADNI")
    parser.add_argument("-P", "--procedure", default="UCA-gPoE")
    parser.add_argument("--out", default="experiment_report.md")
    args = parser.parse_args(argv)
    root = Path(project_root) if project_root else Path.cwd()
    report = generate_report(root, args.dataset_resourse, args.procedure,
                             args.out)
    print(f"wrote {args.out} ({len(report.splitlines())} lines)")


if __name__ == "__main__":
    run()
