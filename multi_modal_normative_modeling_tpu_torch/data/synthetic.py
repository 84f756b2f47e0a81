"""Synthetic cohort generator.

The reference's data CSVs are git-ignored (downloaded from Google Drive), so
tests and benchmarks here synthesize cohorts with the exact on-disk layout the
pipeline expects:

  data/<resource>/y.csv                 columns: IID, participant_id, DIA,
                                        AGE, PTGENDER
  data/<resource>/<modality>.csv        columns: IID, <roi columns...>
  data/<resource>/early_fusion_modalities_<resource>.csv  (when requested)

Disease subjects get a deterministic per-ROI offset so that deviation-based
classification has real signal (AUC well above chance), which lets end-to-end
tests assert pipeline correctness, not just plumbing.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import pandas as pd

from .. import registry


def make_synthetic_resource(
    root: Path,
    resource: str = "ADNI",
    n_hc: int = 120,
    n_disease: Dict[int, int] | None = None,
    seed: int = 0,
    effect: float = 1.5,
    offset_effect: float = 0.8,
    label_noise: float = 0.0,
    modalities: Optional[Sequence[str]] = None,
    with_early_fusion: bool = False,
    with_fi: bool = False,
) -> Path:
    """Write a synthetic cohort for ``resource`` under ``root/data/<resource>``.

    n_disease maps DIA label -> count (defaults chosen per resource's label
    scheme). Returns the resource data directory.

    ``label_noise`` is the fraction of disease-labelled subjects that carry
    NO disease signal (drawn once per subject, consistent across
    modalities) — diagnostic heterogeneity that bounds the achievable AUC
    below 1.0 the way real cohorts do (the reference's published regime is
    AUC ~0.54-0.83, cvae_auc_and_std.csv / result_multimodal.txt), so
    quality-parity probes discriminate instead of saturating. 0.0 (the
    default) leaves every existing cohort bit-identical.
    """
    rng = np.random.default_rng(seed)
    hc_label = registry.get_hc_label(resource)
    if n_disease is None:
        if resource == "ADNI":
            n_disease = {0: n_hc // 2, 1: n_hc // 2}
        elif resource == "ADHD":
            # ADHD's HC label is 1 and its analysis pairs are
            # [[2,0],[2,1],[1,0]] (registry.HC_PATIENT_COMBINATIONS):
            # disease labels must avoid 1 and include 2
            n_disease = {0: n_hc // 2, 2: n_hc // 2}
        else:
            n_disease = {0: n_hc // 2}
    if hc_label in n_disease:
        raise ValueError(
            f"n_disease may not use {resource}'s HC label {hc_label}: "
            f"{n_disease}")

    data_dir = Path(root) / "data" / resource
    data_dir.mkdir(parents=True, exist_ok=True)

    labels: List[int] = [hc_label] * n_hc
    for lab, count in sorted(n_disease.items()):
        labels += [lab] * count
    n = len(labels)
    iids = [f"{resource}_S_{i:05d}" for i in range(n)]
    # No participant_id column: the loader synthesizes it from IID for the
    # plain-IID format (utils.py:153-165), as the reference's ADNI y.csv does.
    y = pd.DataFrame(
        {
            "IID": iids,
            "DIA": labels,
            "AGE": rng.integers(55, 95, size=n),
            "PTGENDER": rng.integers(1, 3, size=n),
        }
    )
    y.to_csv(data_dir / "y.csv", index=False)

    modality_names = list(
        modalities
        if modalities is not None
        else registry.BASE_MODALITIES[resource]
    )
    dia = np.asarray(labels)
    carrier = np.ones(n, dtype=bool)
    if label_noise > 0.0:
        # dedicated stream: the default path stays bit-identical, and the
        # carrier mask is shared by every modality (a non-carrier subject
        # looks healthy everywhere, like a mislabel/subclinical case)
        noise_rng = np.random.default_rng(seed + 777)
        carrier = noise_rng.random(n) >= label_noise
    fusion_blocks = []
    for m_idx, name in enumerate(modality_names):
        cols = registry.get_column_name(resource, name)
        d = len(cols)
        base = rng.normal(0.0, 1.0, size=(n, d))
        # Disease signal has two components:
        #  * per-subject noise on a sparse ROI mask — unreconstructable by a
        #    normative model, so disease rows get genuinely higher
        #    reconstruction deviation (drives the deviation-AUC tests);
        #  * a shared mean offset — encodable in the latent, so supervised
        #    latent classifiers (end-to-end variants) have signal too.
        sig_rng = np.random.default_rng(1000 + m_idx)
        roi_mask = (sig_rng.random(d) < 0.4).astype(float)
        perturb = sig_rng.normal(0.0, 1.0, size=(n, d)) * roi_mask[None, :]
        offset = sig_rng.normal(0.0, 1.0, size=d) * roi_mask
        is_disease = (dia[:, None] != hc_label) & carrier[:, None]
        base += np.where(is_disease, effect, 0.0) * perturb
        base += np.where(is_disease, offset_effect, 0.0) * offset[None, :]
        frame = pd.DataFrame(base, columns=cols)
        frame.insert(0, "IID", iids)
        frame.to_csv(data_dir / f"{name}.csv", index=False)
        if with_early_fusion:
            fusion_blocks.append(
                frame.set_index("IID").rename(
                    columns=lambda c: f"{c}_{name}")
            )

    if with_early_fusion:
        fused = pd.concat(fusion_blocks, axis=1)
        fused.to_csv(data_dir / f"early_fusion_modalities_{resource}.csv")

    if with_fi:
        y["FI"] = (rng.normal(25, 5, size=n) - 3.0 * (dia != hc_label)).round(2)
        y.to_csv(data_dir / "y.csv", index=False)

    return data_dir
