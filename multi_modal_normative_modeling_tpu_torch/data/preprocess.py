"""Feature scaling and covariate encoding (counterpart of
data/preprocess.py).

Parity notes (SURVEY.md Q5):
  * Scaling is sklearn's ``RobustScaler`` fit on the fold's *train* rows; the
    test script re-fits it from train rows itself
    (multimodal_kfold_test_cvae_supervised.py:82-90). The numpy path here is
    bit-identical to sklearn's; the port does not import sklearn, so input
    with NaNs raises.
  * Covariates are one-hot encodings of ``pd.qcut`` bins over the
    rank(method='first') of AGE (27 bins) and PTGENDER (2 bins)
    (multimodal_kfold_train_cvae_supervised.py:107-126); at test time the
    binning is re-fit on the test set itself (test:93-97), reproduced as-is.
  * The scoring surfaces (cli/score.py, cli/serve.py) bin new subjects by
    the fold's train cohort instead (``train_binned_covariates``), so a
    subject's score does not depend on who else is scored with it; an
    exported scoring program (cli/export.py) does the same in its graph
    (``binned_covariate_graph_spec``, ``apply_binned_covariate_spec``).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np
import pandas as pd


@dataclass
class RobustScalerParams:
    """Center/scale of a fitted RobustScaler as plain numpy (device-friendly)."""
    center: np.ndarray
    scale: np.ndarray

    def transform(self, x: np.ndarray) -> np.ndarray:
        return (np.asarray(x) - self.center) / self.scale

    def inverse_transform(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x) * self.scale + self.center


def fit_robust_scaler(train_data: np.ndarray) -> Tuple[np.ndarray, RobustScalerParams]:
    """RobustScaler fit on ``train_data``: returns (scaled, params).

    One C-level ``np.percentile`` across all columns, bit-identical to
    sklearn's per-column ``nanpercentile`` loop on NaN-free input
    (tests/test_torch_data.py). NaNs are sklearn's territory and raise here.
    """
    a = np.asarray(train_data, dtype=np.float64)
    if a.ndim != 2 or np.isnan(a).any():
        raise ValueError(
            'fit_robust_scaler takes a NaN-free [rows, features] array; got '
            f'shape {a.shape} with {int(np.isnan(a).sum())} NaN entries '
            '(drop or impute them before scaling)')
    center = np.median(a, axis=0)
    q25, q75 = np.percentile(a, [25.0, 75.0], axis=0)
    scale = q75 - q25
    # sklearn's _handle_zeros_in_scale: near-zero IQR -> 1.0
    scale[scale < 10 * np.finfo(scale.dtype).eps] = 1.0
    params = RobustScalerParams(center=center, scale=scale)
    return params.transform(a), params


@lru_cache(maxsize=256)
def _qcut_codes_for_ranks(n: int, q: int) -> np.ndarray:
    """Bin code of each rank 1..n under ``pd.qcut(ranks, q)``.

    rank(method='first') is always a permutation of 1..n, so qcut's bin
    edges — and the code assigned to every rank value — depend only on
    (n, q). Computed once per shape with pandas itself (exact semantics)."""
    return np.asarray(
        pd.qcut(pd.Series(np.arange(1, n + 1, dtype=np.float64)), q=q,
                labels=list(range(q))),
        dtype=int)


def qcut_rank_one_hot(values: pd.Series, q: int) -> np.ndarray:
    """One-hot of ``pd.qcut(values.rank(method='first'), q)`` bin codes.

    This is the exact covariate binning of the reference train/test scripts.
    rank(method='first') of column ``v`` equals the inverse of a stable
    argsort, and qcut over a permutation of 1..n has (n, q)-only bin edges —
    so the pandas rank+qcut pair collapses to one stable argsort plus a
    cached code table (bit-identical; tests/test_data_layer.py::
    test_qcut_rank_one_hot_matches_pandas). NaNs fall back to pandas (the
    reference would crash on them anyway — rank propagates NaN into the
    int cast)."""
    try:
        vals = np.asarray(values, dtype=np.float64)
    except (TypeError, ValueError):
        # non-numeric covariates (e.g. string PTGENDER): pandas rank sorts
        # them lexicographically — exactly what the reference does
        bins = pd.qcut(pd.Series(values).rank(method="first"), q=q,
                       labels=list(range(q)))
        return np.eye(q)[np.asarray(bins, dtype=int)]
    n = vals.shape[0]
    if np.isnan(vals).any():
        bins = pd.qcut(pd.Series(values).rank(method="first"), q=q,
                       labels=list(range(q)))
        return np.eye(q)[np.asarray(bins, dtype=int)]
    order = np.argsort(vals, kind="stable")
    ranks = np.empty(n, dtype=np.intp)
    ranks[order] = np.arange(n, dtype=np.intp)
    codes = _qcut_codes_for_ranks(n, q)[ranks]
    out = np.zeros((n, q), dtype=np.float64)
    out[np.arange(n), codes] = 1.0
    return out


def one_hot_covariates(covariates: pd.DataFrame, n_bins_age: int = 27,
                       n_bins_gender: int = 2) -> np.ndarray:
    """``concat(one_hot(AGE qcut), one_hot(PTGENDER qcut))`` as float32.

    c_dim = n_bins_age + n_bins_gender (29 by default), matching
    multimodal_kfold_train_cvae_supervised.py:107-128.
    """
    one_hot_age = qcut_rank_one_hot(covariates["AGE"], n_bins_age)
    one_hot_gender = qcut_rank_one_hot(covariates["PTGENDER"], n_bins_gender)
    return np.concatenate((one_hot_age, one_hot_gender), axis=1).astype("float32")


def binary_labels(dia: pd.Series, hc_label: int) -> np.ndarray:
    """0 for healthy controls, 1 otherwise (nmpmcont process_dataset:121)."""
    return (np.asarray(dia) != hc_label).astype(np.int64)


def train_binned_covariates(train_cov: pd.DataFrame, new_cov: pd.DataFrame,
                            n_bins_age: int = 27,
                            n_bins_gender: int = 2) -> np.ndarray:
    """Serving-path covariate one-hot: bin NEW subjects by quantile edges
    fit on the fold's TRAIN covariates.

    The k-fold evaluation path deliberately re-bins each test split on
    itself (reference quirk, SURVEY.md Q5) — fine for fixed folds, but for
    arbitrary scoring cohorts it would make a subject's conditioning (and
    deviation score) depend on who else is in the ids CSV, and crash for a
    single-subject list. Train-derived edges are cohort-independent and
    defined for any batch size.
    """

    def by_identity(cats, new, q, label):
        # low-cardinality covariates (string or numeric-coded gender) bin by
        # value identity, one bin per sorted train category. Quantile edges
        # are WRONG here: with a majority-low binary (36x'1'/24x'2') the
        # median edge is 1.0 and side='right' maps both genders into one
        # bin, silently dropping the conditioning. A value absent from the
        # train cohort (incl. type skew like numeric-train vs string-
        # serving) has no meaningful bin, and more train categories than
        # bins would force two demographics to share an encoding — both
        # raise rather than silently mis-condition.
        if len(cats) > q:
            raise ValueError(
                f'{label}: {len(cats)} distinct training categories '
                f'{list(cats)} exceed the {q} covariate bins; cannot bin '
                'for serving without merging demographics')
        codes = np.searchsorted(cats, new)
        bad = (codes >= len(cats)) | (cats[np.minimum(codes, len(cats) - 1)]
                                      != new)
        if bad.any():
            raise ValueError(
                f'{label}: covariate value(s) {sorted(set(new[bad]))} not '
                f'in the training cohort categories {list(cats)}; cannot '
                'bin for serving')
        return np.eye(q)[codes]

    def one_hot(train_vals, new_vals, q, label):
        try:
            train = np.asarray(train_vals, dtype=np.float64)
            new = np.asarray(new_vals, dtype=np.float64)
        except (TypeError, ValueError):
            # categorical covariates (e.g. string PTGENDER), lexicographic
            # category order (like pandas rank)
            return by_identity(np.unique(np.asarray(train_vals, dtype=str)),
                               np.asarray(new_vals, dtype=str), q, label)
        uniq = np.unique(train)
        if len(uniq) <= q:
            # nearest-train-value binning for low-cardinality numerics:
            # quantile edges collapse a majority-low binary (36x'1'/24x'2'
            # -> median edge 1.0 maps BOTH genders into one bin, silently
            # dropping the conditioning), while strict identity would
            # reject in-between values (a tiny cohort whose AGE has <= q
            # distinct values must still bin a new age of 70.5)
            codes = np.argmin(np.abs(new[:, None] - uniq[None, :]), axis=1)
            return np.eye(q)[codes]
        edges = np.quantile(train, np.linspace(0.0, 1.0, q + 1)[1:-1])
        codes = np.searchsorted(edges, new, side="right")
        return np.eye(q)[codes]

    return np.concatenate(
        (one_hot(train_cov["AGE"], new_cov["AGE"], n_bins_age, 'AGE'),
         one_hot(train_cov["PTGENDER"], new_cov["PTGENDER"], n_bins_gender,
                 'PTGENDER')),
        axis=1,
    ).astype("float32")


def binned_covariate_graph_spec(train_cov: pd.DataFrame,
                                n_bins_age: int = 27,
                                n_bins_gender: int = 2) -> list:
    """Constants for an in-graph (jax-traceable) equivalent of
    train_binned_covariates, so an AOT-exported scoring program
    (cli/export.py) can bin NEW subjects' covariates on-device.

    Only numeric covariates can be baked into an exported program — the
    categorical by-identity path needs string comparison, which has no
    device representation; such cohorts must be served by cli/serve.py
    (host-side binning) instead, so they raise here.

    Returns one dict per covariate: ``mode='nearest'`` carries the sorted
    train uniques (nearest-train-value coding, the <= q-category branch) or
    ``mode='quantile'`` carries the inner quantile edges (searchsorted
    side='right') — exactly train_binned_covariates' numeric branches.
    """
    spec = []
    for col, q in (('AGE', n_bins_age), ('PTGENDER', n_bins_gender)):
        try:
            train = np.asarray(train_cov[col], dtype=np.float64)
        except (TypeError, ValueError):
            raise ValueError(
                f'{col}: categorical (non-numeric) training covariates '
                'cannot be compiled into an exported scoring program; '
                'serve this model with cli/serve.py (host-side binning) '
                'instead') from None
        uniq = np.unique(train)
        if len(uniq) > q:
            edges = np.quantile(train, np.linspace(0.0, 1.0, q + 1)[1:-1])
            # the exported program compares in float32: round each float64
            # edge UP to the nearest float32. For any float32 input x this
            # makes (edge_f32 <= x) <=> (edge_f64 <= x) — i.e. searchsorted
            # side='right' bins exactly like the float64 host path
            # (train_binned_covariates) — because no float32 can lie
            # strictly between edge_f64 and its round-up. Rounding to
            # nearest instead would flip edge-adjacent subjects into the
            # wrong bin.
            e32 = edges.astype(np.float32)
            e32 = np.where(e32.astype(np.float64) < edges,
                           np.nextafter(e32, np.float32(np.inf)), e32)
            spec.append({'mode': 'quantile', 'values': e32, 'q': q,
                         'col': col})
        else:
            # nearest-train-value coding; float32 rounding of the train
            # uniques can flip a subject sitting within one float32 ulp of
            # the midpoint between two adjacent train values — inherent to
            # an f32 program, and far below covariate measurement noise
            spec.append({'mode': 'nearest', 'values': uniq, 'q': q,
                         'col': col})
    return spec


def apply_binned_covariate_spec(spec: list, age, gender):
    """One-hot covariates [n, n_bins_age + n_bins_gender] from a
    binned_covariate_graph_spec, in torch ops only (``torch.export``
    traces them with a symbolic batch): the nearest train value is the
    first index of the least absolute difference (``torch.argmin``, as
    ``jnp.argmin``), a quantile bin the count of edges at or below the
    value (``searchsorted(right=True)``). ``age`` and ``gender`` are [n]
    tensors; the result is float32 on their device. Matches
    train_binned_covariates on numeric cohorts up to float32 rounding of
    the bin edges (tests/test_torch_export.py)."""
    import torch

    outs = []
    for entry, new in zip(spec, (age, gender)):
        vals = torch.as_tensor(np.asarray(entry['values'], np.float32),
                               device=new.device)
        outs.append(one_hot_codes(entry['mode'], vals, new, entry['q']))
    return torch.cat(outs, dim=1)


def one_hot_codes(mode: str, vals, new, q: int):
    """float32 one-hot [n, q] of ``new`` [n] binned by ``vals`` (the train
    uniques or the inner quantile edges, float32, on ``new``'s device)."""
    import torch

    new = new.to(torch.float32)
    if mode == 'nearest':
        codes = torch.argmin(torch.abs(new[:, None] - vals[None, :]), dim=1)
    else:
        codes = torch.searchsorted(vals, new, right=True)
    bins = torch.arange(q, device=new.device)
    return (codes[:, None] == bins[None, :]).to(torch.float32)
