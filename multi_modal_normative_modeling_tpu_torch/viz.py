"""Visualization utilities (counterpart of viz.py), the script equivalents
of the reference's side notebooks (tsne.ipynb, table_visualization.ipynb,
visualization/ROI.ipynb): the latent t-SNE scatter, per-ROI deviation
tables, maps and glass-brain scatters, AUC summary tables, and the vendored
atlas geometry (data/aal90_mni_centroids.json, data/brain_outline_2d.json,
byte copies of the JAX package's).

The tables need pandas and numpy only. The figures (``tsne_latents``,
``roi_deviation_map``, ``glass_brain_scatter``) draw with matplotlib, and
the t-SNE also needs scikit-learn's ``TSNE``; each imports them when
called, and where one is absent (the machine with the GPU has neither)
raises ``ModuleNotFoundError`` naming it. Their drawing code is the JAX
package's, so a figure drawn from the same data is the same image.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import pandas as pd


def _require(module: str, what: str):
    """Import ``module`` for ``what``; where its package is absent, a
    ModuleNotFoundError that names the package."""
    import importlib

    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        package = module.split(".")[0]
        raise ModuleNotFoundError(
            f"{what} needs {package}, which is not installed here: the "
            "figures draw only where it is", name=package) from e


def tsne_latents(latents: np.ndarray, labels: np.ndarray, out_path,
                 perplexity: float = 30.0, seed: int = 42) -> np.ndarray:
    """2-D t-SNE embedding of latent means, colored by diagnosis; saves a PNG
    and returns the embedding (tsne.ipynb equivalent)."""
    matplotlib = _require("matplotlib", "tsne_latents")
    TSNE = _require("sklearn.manifold", "tsne_latents").TSNE
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    latents = np.asarray(latents)
    perplexity = min(perplexity, max(2.0, (len(latents) - 1) / 3.0))
    embedding = TSNE(n_components=2, perplexity=perplexity,
                     random_state=seed).fit_transform(latents)
    plt.figure(figsize=(6, 6))
    for value in np.unique(labels):
        sel = np.asarray(labels) == value
        plt.scatter(embedding[sel, 0], embedding[sel, 1], s=12,
                    label=f"DIA={value}", alpha=0.7)
    plt.legend()
    plt.title("t-SNE of latent means")
    plt.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close()
    return embedding


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


def roi_deviation_map(roi_error_csv, hc_label: int, out_path,
                      top_k: int = 25) -> None:
    """Horizontal-bar deviation map of the top-k ROIs by effect size."""
    matplotlib = _require("matplotlib", "roi_deviation_map")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    table = roi_deviation_table(roi_error_csv, hc_label, top_k)
    plt.figure(figsize=(7, max(3, 0.3 * len(table))))
    plt.barh(table["roi"][::-1], table["cohens_d"][::-1])
    plt.xlabel("Cohen's d (patient vs HC deviation)")
    plt.title("ROI deviation map")
    plt.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close()


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


def glass_brain_scatter(roi_values: dict, out_path, title: str = "",
                        cmap: str = "coolwarm", label: str = "Cohen's d",
                        annotate_top: int = 6) -> None:
    """Per-ROI brain map (equivalent of the reference's
    visualization/enhanced_roi_visualization.png, which renders per-ROI
    deviation onto the AAL atlas via nilearn): three glass-brain projections
    (axial, sagittal, coronal) drawn over vendored brain-outline contours,
    with one marker per region at its vendored approximate centroid,
    color = value, size ~ |value|.

    ``roi_values``: mapping AAL label (e.g. 'Hippocampus_L') -> scalar.
    """
    matplotlib = _require("matplotlib", "glass_brain_scatter")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import cm as mpl_cm
    from matplotlib.colors import Normalize

    cents = aal90_centroids()
    labels = [k for k in roi_values if k in cents]
    if not labels:
        raise ValueError(
            "glass_brain_scatter: no roi_values keys match the vendored "
            "AAL-90 centroid labels (e.g. 'Hippocampus_L'); got keys like "
            f"{list(roi_values)[:3]}")
    xyz = np.array([cents[k] for k in labels])
    vals = np.array([float(roi_values[k]) for k in labels])
    vmax = max(1e-9, np.abs(vals).max())
    norm = Normalize(vmin=-vmax, vmax=vmax)
    sizes = 40 + 260 * (np.abs(vals) / vmax)

    outlines = brain_outlines()
    views = [("axial (top)", "axial"),
             ("sagittal (left)", "sagittal"),
             ("coronal (front)", "coronal")]
    fig, axes = plt.subplots(1, 3, figsize=(15, 5.2))
    top_idx = np.argsort(-np.abs(vals))[:annotate_top]
    for ax, (name, view) in zip(axes, views):
        spec = outlines[view]
        i, j = spec["dims"]
        for k, path in enumerate(spec["paths"]):
            pts = np.asarray(path, float)
            # first path = outer contour; the rest are inner structures
            # (fissure, cerebellum) drawn lighter
            ax.plot(pts[:, 0], pts[:, 1], color="0.45" if k == 0 else "0.7",
                    lw=1.6 if k == 0 else 1.0, solid_joinstyle="round",
                    zorder=1)
        ax.scatter(xyz[:, i], xyz[:, j], c=vals, s=sizes, cmap=cmap,
                   norm=norm, alpha=0.85, edgecolors="0.4",
                   linewidths=0.4, zorder=2)
        for t in top_idx:
            ax.annotate(labels[t], (xyz[t, i], xyz[t, j]), fontsize=7,
                        xytext=(3, 3), textcoords="offset points")
        ax.set_title(name)
        ax.set_aspect("equal")
        ax.axis("off")
    fig.colorbar(mpl_cm.ScalarMappable(norm=norm, cmap=cmap), ax=axes,
                 shrink=0.8, label=label)
    if title:
        fig.suptitle(title)
    fig.savefig(out_path, dpi=130, bbox_inches="tight")
    plt.close(fig)


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
