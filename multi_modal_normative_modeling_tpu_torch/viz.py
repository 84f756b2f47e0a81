"""Visualization utilities (counterpart of viz.py): the tables of the
reference's side notebooks (table_visualization.ipynb,
visualization/ROI.ipynb), per-ROI deviation effect sizes and AUC summaries,
and the vendored atlas geometry (data/aal90_mni_centroids.json,
data/brain_outline_2d.json, byte copies of the JAX package's). pandas and
numpy only.

Not ported: the figure functions (``tsne_latents``, ``roi_deviation_map``,
``glass_brain_scatter``), ROADMAP queue 1 item 'Tooling'; they need
matplotlib (and scikit-learn's t-SNE), which the machine with the GPU does
not have.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import pandas as pd


def roi_deviation_table(roi_error_csv, hc_label: int,
                        top_k: Optional[int] = 20) -> pd.DataFrame:
    """Per-ROI mean deviation split HC vs patient + Cohen's d, sorted by
    effect size (visualization/ROI.ipynb equivalent). Input is a
    reconstruction_error_roi_*.csv emitted by the test stage."""
    frame = pd.read_csv(roi_error_csv)
    meta = ["participant_id", "DIA", "AGE", "PTGENDER"]
    roi_cols = [c for c in frame.columns if c not in meta]
    hc = frame[frame["DIA"] == hc_label][roi_cols]
    patient = frame[frame["DIA"] != hc_label][roi_cols]
    pooled = np.sqrt((hc.var(ddof=1) + patient.var(ddof=1)) / 2.0)
    table = pd.DataFrame({
        "roi": roi_cols,
        "hc_mean_dev": hc.mean().values,
        "patient_mean_dev": patient.mean().values,
        "cohens_d": ((patient.mean() - hc.mean()) / pooled).values,
    })
    # rank by |d|: a strongly HC-elevated ROI is a large effect too (the
    # signed value stays in the output/plot)
    table = table.reindex(
        table["cohens_d"].abs().sort_values(ascending=False).index
    ).reset_index(drop=True)
    return table if top_k is None else table.head(top_k)


def aal90_centroids() -> dict:
    """label -> (x, y, z) approximate MNI centroid for all 90 AAL regions
    (vendored, data/aal90_mni_centroids.json; right hemisphere mirrored in x).
    Visualization geometry only — the reference's ROI notebook loads the real
    atlas through nilearn at runtime (no offline equivalent in this image)."""
    import json

    path = Path(__file__).parent / "data" / "aal90_mni_centroids.json"
    base = {k: v for k, v in json.loads(path.read_text()).items()
            if not k.startswith("_")}
    out = {}
    for name, (x, y, z) in base.items():
        out[f"{name}_L"] = (float(x), float(y), float(z))
        out[f"{name}_R"] = (-float(x), float(y), float(z))
    return out


def brain_outlines() -> dict:
    """Vendored simplified 2-D brain outline polylines per projection
    (data/brain_outline_2d.json, MNI mm; hand-authored approximations) —
    the nilearn-free stand-in for nilearn's glass-brain boilerplate."""
    import json

    path = Path(__file__).parent / "data" / "brain_outline_2d.json"
    return json.loads(path.read_text())


def auc_summary_table(result_dirs: Sequence, out_csv=None) -> pd.DataFrame:
    """Collect cvae_auc_and_std.csv files into one experiment table
    (table_visualization.ipynb equivalent)."""
    rows = []
    for directory in result_dirs:
        path = Path(directory) / "cvae_auc_and_std.csv"
        if not path.exists():
            continue
        values = np.loadtxt(path, delimiter=",")
        rows.append({
            "experiment": str(directory),
            "mean_auc": float(values[:-1].mean()),
            "std_auc": float(values[-1]),
            "n_folds": int(len(values) - 1),
        })
    table = pd.DataFrame(rows)
    if out_csv is not None and len(table):
        table.to_csv(out_csv, index=False)
    return table
