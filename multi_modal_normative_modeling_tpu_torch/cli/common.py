"""Per-fold data prep for the port's CLIs: the jax-free subset of the JAX
package's cli/common.py (prepare_modality, fold_paths,
assert_modalities_aligned, require_test_cov, infer_row_tile,
build_model_from_config), without its process-wide memo caches.

The registry and the data layer (loading, scaling, covariate binning) are
the JAX package's own modules, which import neither jax nor flax.
"""
from __future__ import annotations

import csv
from pathlib import Path
from typing import Tuple

import numpy as np
import pandas as pd

from multi_modal_normative_modeling_tpu import registry
from multi_modal_normative_modeling_tpu.data.loading import (
    fast_inner_merge,
    load_demographic_data,
)
from multi_modal_normative_modeling_tpu.data.preprocess import (
    fit_robust_scaler,
    one_hot_covariates,
)

# The JAX package parses modality tables of at least this many columns with
# its native loader, which rounds every value correctly; pandas' default
# parser may differ by 1 ulp, its round-trip parser does not.
_WIDE_TABLE_COLS = 256


def read_csv(path) -> pd.DataFrame:
    """pd.read_csv, parsing wide modality tables exactly as the JAX package
    does, so both packages scale identical values."""
    with open(path, newline="") as f:
        header = next(csv.reader(f))
    if "IID" in header and len(header) >= _WIDE_TABLE_COLS:
        return pd.read_csv(path, float_precision="round_trip")
    return pd.read_csv(path)


def load_dataset(demographic_path, ids_path, modality_path,
                 read=read_csv) -> pd.DataFrame:
    """Merge a modality table with the demographic rows of ``ids_path``
    (cli/common.py::load_dataset_cached of the JAX package). ``read`` gives
    the demographic and modality tables; the test stage passes a lookup of
    tables it parsed once, so k folds share them."""
    demographic_df = read(demographic_path).dropna()
    ids_df = pd.read_csv(ids_path, usecols=['IID'])
    if ('Run_ID' in demographic_df.columns
            or 'Session_ID' in demographic_df.columns):
        # composite id formats: the reference-exact loader
        demographic = load_demographic_data(demographic_path, ids_path)
    else:
        ids_df = ids_df.copy()
        if 'participant_id' not in demographic_df.columns:
            ids_df['participant_id'] = ids_df['IID']
        demographic = fast_inner_merge(ids_df, demographic_df, on='IID')
    return fast_inner_merge(read(modality_path), demographic, on='IID')


def prepare_modality(project_root: Path, resource: str, dataset_name: str,
                     participants_path, train_ids_path,
                     test_ids_path=None, read=read_csv) -> dict:
    """Load + scale one modality for a fold, reference test/train semantics:
    RobustScaler fit on the fold's train rows, applied to both splits;
    qcut one-hot covariates fit independently per split (SURVEY.md Q5)."""
    columns_name = registry.get_column_name(resource, dataset_name)
    modality_path = (Path(project_root) / 'data' / resource
                     / f'{dataset_name}.csv')
    train_df = load_dataset(participants_path, train_ids_path, modality_path,
                            read)
    train_data, scaler = fit_robust_scaler(train_df[columns_name].values)
    out = {
        'columns': columns_name,
        'train_df': train_df,
        'train_data': train_data.astype(np.float32),
        'train_cov': one_hot_covariates(train_df[['DIA', 'PTGENDER', 'AGE']]),
        'scaler': scaler,
    }
    if test_ids_path is not None:
        test_df = load_dataset(participants_path, test_ids_path,
                               modality_path, read)
        out['test_df'] = test_df
        # float64, like the reference's scaled DataFrame (test:90); the
        # device path downcasts to float32
        out['test_data'] = scaler.transform(test_df[columns_name].values)
        try:
            out['test_cov'] = one_hot_covariates(
                test_df[['DIA', 'AGE', 'PTGENDER']])
        except ValueError as e:
            # fewer test rows than qcut bins: keep the reason for
            # require_test_cov
            out['test_cov'] = None
            out['test_cov_error'] = str(e)
    return out


def assert_modalities_aligned(frames, context: str,
                              key: str = 'participant_id') -> None:
    """Every modality's merged frame must cover the same subjects in the
    same order: the stacked inference pairs modality-0 row indices and
    participant ids with the LAST modality's covariates (reference test:102
    semantics)."""
    base = frames[0][key].to_numpy()
    for i, frame in enumerate(frames[1:], 1):
        cur = frame[key].to_numpy()
        if len(cur) != len(base) or not (cur == base).all():
            raise ValueError(
                f"{context}: modality row sets/orders differ between "
                f"modality 0 ({len(base)} rows) and modality {i} "
                f"({len(cur)} rows); every modality CSV must cover the "
                "same subjects in the same order")


def require_test_cov(prep: dict, context: str) -> np.ndarray:
    """A prep's qcut test covariates, or the original qcut error."""
    cov = prep.get('test_cov')
    if cov is None:
        raise ValueError(
            f"{context}: test covariates unavailable — "
            f"{prep.get('test_cov_error', 'qcut binning failed')}. "
            "The k-fold test stage needs >= bin-count test rows per fold.")
    return cov


def fold_paths(kfold_dir: Path, fold: int) -> Tuple[Path, Path]:
    return (kfold_dir / f'train_ids_{fold:03d}.csv',
            kfold_dir / f'test_ids_{fold:03d}.csv')


def infer_row_tile() -> int:
    """Row-padding bucket of the scoring call (the JAX package's, without a
    mesh): every fold is padded to the same multiple of it, so the padded
    rows, and with them the eps draw of each fold, match the JAX stage."""
    return 64


def build_model_from_config(config: dict, folds: int = 1, device=None):
    """The model a checkpoint's cVAE_model.json describes, holding
    ``folds`` folds."""
    from ..models import build_model

    return build_model(
        config['model'], config['input_dim_list'], config['hidden_dim'],
        config['latent_dim'], config['c_dim'], config['modalities'],
        config.get('non_linear', True), folds=folds, device=device,
    )
