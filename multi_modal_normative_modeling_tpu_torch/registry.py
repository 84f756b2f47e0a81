"""Dataset / modality / column-name registries and the procedure grammar.

Re-implements the registry functions of the reference `utils.py` (see
utils.py:699 `get_column_name`, :731 `get_datasets_name`, :760 `get_hc_label`)
without the reference's import-time side effects: the AAL-116 atlas labels are
vendored in ``data/roi_labels.json`` instead of being fetched from nilearn at
import (utils.py:450-452).

The *procedure grammar* is the reference's real configuration language
(utils.py:731-755):

  ``SM-<modality>``  single modality (e.g. ``SM-av45``)
  ``SE-<fusion>``    separate encoders per base modality, latents fused by
                     <fusion> in {PoE, gPoE, MoE, MoPoE}
  ``UCA-<fusion>``   SE plus an early-fusion concatenation of all base
                     modalities appended as an extra modality
"""
from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import List

_LABELS_PATH = Path(__file__).parent / "data" / "roi_labels.json"


@functools.lru_cache(maxsize=1)
def _labels() -> dict:
    with open(_LABELS_PATH) as f:
        return json.load(f)


def _aal90() -> List[str]:
    return list(_labels()["aal90"])


def _vbm90() -> List[str]:
    return list(_labels()["vbm_mni90"])


def _snp54() -> List[str]:
    return list(_labels()["adni_snp54"])


def _aal116() -> List[str]:
    return list(_labels()["aal116"])


# ---------------------------------------------------------------------------
# Public column registries (same names as the reference utils.py exports so
# downstream code written against the reference keeps working).
# ---------------------------------------------------------------------------

def __getattr__(name: str):
    # Lazy module attributes so importing the package never touches disk
    # unless a registry is actually used.
    if name == "COLUMNS_NAME":
        return _aal90()
    if name == "COLUMNS_NAME_VBM":
        return _vbm90()
    if name == "COLUMNS_NAME_SNP":
        return _snp54()
    if name == "COLUMNS_NAME_AAL116":
        return _aal116()
    if name == "COLUMNS_HCP":
        return ["HCP_" + str(i) for i in range(132)]
    if name == "COLUMNS_NAME_PPMI":
        return [str(i) for i in range(3485)]
    if name == "COLUMNS_3MODALITIES":
        # ADNI early-fusion column order: av45 block, fdg block, vbm block
        # (verified equal to the reference literal utils.py:177-449).
        return (
            [c + "_av45" for c in _aal90()]
            + [c + "_fdg" for c in _aal90()]
            + [c + "_vbm" for c in _vbm90()]
        )
    if name == "COLUMNS_NAME_HCP_fMRI_100":
        # Referenced by the reference's early_fusion_modalities.py:3 but never
        # defined there (known defect, SURVEY.md section 2.1). Provide it so the
        # early-fusion entry point is importable.
        return ["fMRI_" + str(i) for i in range(100)]
    raise AttributeError(name)


BASE_MODALITIES = {
    "ADNI": ["av45", "vbm", "fdg"],
    "HCP": [
        "T1_volume", "mean_T1_intensity", "mean_FA", "mean_MD", "mean_L1",
        "mean_L2", "mean_L3", "min_BOLD", "25_percentile_BOLD",
        "50_percentile_BOLD", "75_percentile_BOLD", "max_BOLD",
    ],
    "ADHD": ["fMRI", "sMRI"],
    "PPMI": [
        "PPMI_new_modal1_upper_tri",
        "PPMI_new_modal2_upper_tri",
        "PPMI_new_modal3_upper_tri",
    ],
    "HCPimage": ["T1w_sMRI", "T2w_sMRI", "fMRI"],
}

HC_LABELS = {"ADNI": 2, "HCP": 1, "ADHD": 1, "PPMI": 1, "HCPimage": 1}

# hc/disease label pairs iterated by the group analysis
# (multimodal_kfold_cvae_group_analysis_1x1.py:333-340).
HC_PATIENT_COMBINATIONS = {
    "ADNI": [[2, 0], [2, 1], [1, 0]],
    "HCP": [[1, 0]],
    "ADHD": [[2, 0], [2, 1], [1, 0]],
    "PPMI": [[1, 0]],
    # HCPimage: absent from the reference's if/elif chain (group_analysis
    # :333-340 — running it there raises UnboundLocalError). Its label
    # scheme is hc=1 (utils.py:760-774), so [[1, 0]] makes the registered
    # resource actually analyzable here.
    "HCPimage": [[1, 0]],
}


def get_datasets_name(dataset_resourse: str, procedure: str = "SE-PoE") -> List[str]:
    """Resolve a procedure string to the list of modality dataset names.

    Mirrors utils.py:731-755 including the ``SM-`` single-modality short
    circuit and the ``UCA-`` early-fusion append.
    """
    if procedure.startswith("SM"):
        return [procedure.split("-")[-1]]
    try:
        names = list(BASE_MODALITIES[dataset_resourse])
    except KeyError:
        raise ValueError(f"Unknown dataset: {dataset_resourse}")
    if procedure.startswith("UCA"):
        names.append(f"early_fusion_modalities_{dataset_resourse}")
    return names


def get_column_name(dataset_resourse: str, dataset_name: str) -> List[str]:
    """Feature columns for a (resource, modality) pair (utils.py:699-727)."""
    if dataset_name.startswith("early_fusion_modalities"):
        columns: List[str] = []
        for base in get_datasets_name(dataset_resourse):
            columns += [
                f"{c}_{base}" for c in get_column_name(dataset_resourse, base)
            ]
        return columns

    if dataset_resourse == "ADNI":
        if dataset_name in ("av45", "fdg"):
            return _aal90()
        if dataset_name == "snp":
            return _snp54()
        if dataset_name == "vbm":
            return _vbm90()
        raise ValueError(f"Unknown ADNI modality: {dataset_name}")
    if dataset_resourse == "HCP":
        return [f"{dataset_name}_{i}" for i in range(132)]
    if dataset_resourse in ("ADHD", "HCPimage"):
        return _aal116()
    if dataset_resourse == "PPMI":
        return [str(i) for i in range(3485)]
    raise ValueError(f"Unknown dataset resource: {dataset_resourse}")


def get_hc_label(dataset_resourse: str) -> int:
    """Healthy-control DIA label per resource (utils.py:760-774)."""
    try:
        return HC_LABELS[dataset_resourse]
    except KeyError:
        raise ValueError("Unknown dataset resource")

