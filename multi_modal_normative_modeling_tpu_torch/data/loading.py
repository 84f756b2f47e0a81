"""CSV ingestion for the port's CLIs (counterpart of data/loading.py).

Behavioral parity with the reference data layer:
  * ``load_dataset`` / ``load_demographic_data``  - utils.py:112-168 (merge a
    modality CSV with the demographic table on IID, honoring the three id
    formats Run_ID / Session_ID / plain IID)
  * ``fast_inner_merge``: the numpy row-map join both of them use;
  * the k-fold id writers ``generate_kfold_ids``,
    ``generate_kfold_ids_endtoend`` and ``generate_kfold_ids_with_unigroup``
    (utils.py:19-93), on ``kfold_split``, a copy of sklearn's KFold shuffle,
    so the port needs no sklearn;
  * ``cliff_delta`` (utils.py:97-109).
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import pandas as pd


def fast_inner_merge(left: pd.DataFrame, right: pd.DataFrame,
                     on: str = "IID") -> pd.DataFrame:
    """``pd.merge(left, right, on=on)`` replacement for the pipeline's hot
    joins, bit-identical when one side's keys are unique (both pipeline
    cases: modality/demographic tables have unique IIDs; fold-id lists are
    oversampled with duplicates). Builds the row maps with numpy instead of
    pandas' per-call hash-join + string index engines, which dominate
    per-fold data prep (see tests/test_data_layer.py::
    test_fast_inner_merge_matches_pandas). Falls back to pd.merge whenever
    its assumptions don't hold (shared non-key columns, neither side
    unique)."""
    if (on not in left.columns or on not in right.columns
            or len(left.columns.intersection(right.columns)) != 1):
        return pd.merge(left, right, on=on)

    lk = left[on].to_numpy()
    rk = right[on].to_numpy()
    # NaN keys hash-miss in a dict (NaN != NaN) where pd.merge pairs them,
    # and dtype-mismatched key columns should raise pandas' clear error
    # instead of silently matching nothing — both go to pandas
    if (lk.dtype != rk.dtype
            or (lk.dtype.kind == "f" and (np.isnan(lk).any()
                                          or np.isnan(rk).any()))
            or (lk.dtype == object
                and (pd.isna(lk).any() or pd.isna(rk).any()))):
        return pd.merge(left, right, on=on)
    rpos = {k: j for j, k in enumerate(rk)}
    if len(rpos) == len(rk):
        # unique right keys: result = left rows with a match, in left order
        ridx = np.fromiter((rpos.get(k, -1) for k in lk), dtype=np.intp,
                           count=len(lk))
        lrows = np.flatnonzero(ridx >= 0)
        rrows = ridx[lrows]
    else:
        lpos = {k: j for j, k in enumerate(lk)}
        if len(lpos) != len(lk):
            return pd.merge(left, right, on=on)  # M:N join: pandas semantics
        # unique left keys: each right row attaches to its left row; result
        # ordered by left key, right occurrence order within a key (stable)
        lidx = np.fromiter((lpos.get(k, -1) for k in rk), dtype=np.intp,
                           count=len(rk))
        rrows = np.flatnonzero(lidx >= 0)
        order = np.argsort(lidx[rrows], kind="stable")
        rrows = rrows[order]
        lrows = lidx[rrows]
    out_left = left.take(lrows).reset_index(drop=True)
    out_right = right.drop(columns=[on]).take(rrows).reset_index(drop=True)
    return pd.concat([out_left, out_right], axis=1)


def load_demographic_data(demographic_path, ids_path) -> pd.DataFrame:
    """Load the demographic table restricted to the ids in ``ids_path``.

    Handles the three IID formats of utils.py:125-168: composite
    participant/session/run uids, participant/session uids, or plain IIDs.
    Row order follows the merge order of the reference (ids first for the
    composite formats, ids-left merge for the plain format).
    """
    demographic_df = pd.read_csv(demographic_path).dropna()
    ids_df = pd.read_csv(ids_path, usecols=["IID"])

    if "Run_ID" in demographic_df.columns:
        demographic_df = demographic_df.copy()
        demographic_df["uid"] = (
            demographic_df["participant_id"]
            + "_"
            + demographic_df["Session_ID"]
            + "_run-"
            + demographic_df["Run_ID"].apply(str)
        )
        parts = ids_df["IID"].str.split("_")
        ids_df = ids_df.copy()
        ids_df["uid"] = parts.str[0] + "_" + parts.str[1] + "_" + parts.str[2]
        merged = pd.merge(ids_df, demographic_df, on="uid")
        return merged.drop(columns=["uid"])

    if "Session_ID" in demographic_df.columns:
        demographic_df = demographic_df.copy()
        demographic_df["uid"] = (
            demographic_df["participant_id"] + "_" + demographic_df["Session_ID"]
        )
        parts = ids_df["IID"].str.split("_")
        ids_df = ids_df.copy()
        ids_df["uid"] = parts.str[0] + "_" + parts.str[1]
        merged = pd.merge(ids_df, demographic_df, on="uid")
        return merged.drop(columns=["uid"])

    ids_df = ids_df.copy()
    if "participant_id" not in demographic_df.columns:
        # plain-IID tables (the common case) get participant_id synthesized
        # from IID; when the demographic table already carries one, adding
        # it here would collide in the merge (suffixed _x/_y columns that
        # break every downstream participant_id consumer)
        ids_df["participant_id"] = ids_df["IID"]
    return fast_inner_merge(ids_df, demographic_df, on="IID")


def load_dataset(demographic_path, ids_path, modality_path) -> pd.DataFrame:
    """Merge a modality feature CSV with the demographic table (utils.py:112).

    The modality frame is the left side of the merge, so the returned row
    order follows the modality CSV (matching the reference byte-for-byte for
    the emitted deviation CSVs).
    """
    demographic_data = load_demographic_data(demographic_path, ids_path)
    modality_df = pd.read_csv(modality_path)
    return fast_inner_merge(modality_df, demographic_data, on="IID")


def kfold_split(n_samples: int, n_splits: int, random_state: int = 42):
    """(train_idx, test_idx) per fold, as sklearn's
    KFold(n_splits, shuffle=True, random_state).split yields them: a
    RandomState(random_state) shuffle, the first n % k folds one longer,
    both index sets ascending. The JAX package's fold-id writer calls
    sklearn, which the GPU machine does not have."""
    if not 2 <= n_splits <= n_samples:
        raise ValueError(f'cannot split {n_samples} samples into {n_splits} '
                         'folds')
    indices = np.arange(n_samples)
    np.random.RandomState(random_state).shuffle(indices)
    sizes = np.full(n_splits, n_samples // n_splits, dtype=int)
    sizes[:n_samples % n_splits] += 1
    start = 0
    for size in sizes:
        test = np.zeros(n_samples, dtype=bool)
        test[indices[start:start + size]] = True
        start += size
        yield np.flatnonzero(~test), np.flatnonzero(test)


def _write_fold_ids(kfold_dir: Path, split_frame: pd.DataFrame,
                    oversample_percentage: float, n_splits: int,
                    test_extra: Optional[pd.Series] = None,
                    random_state: int = 42) -> None:
    """The shared body of the three k-fold id writers, without sklearn: the
    KFold split of ``split_frame`` (``test_extra`` joins every test fold),
    the oversampling draws from numpy's global stream, one
    train_ids_NNN.csv / test_ids_NNN.csv pair per fold."""
    kfold_dir.mkdir(parents=True, exist_ok=True)
    for fold, (train_idx, test_idx) in enumerate(
            kfold_split(len(split_frame), n_splits, random_state)):
        train_ids = split_frame.iloc[train_idx]['IID']
        test_ids = split_frame.iloc[test_idx]['IID']
        if test_extra is not None:
            test_ids = pd.concat([test_ids, test_extra])
        size = int(len(train_ids) * oversample_percentage)
        oversampled = np.random.choice(train_ids, size=size, replace=True)
        pd.DataFrame({'IID': oversampled}).to_csv(
            kfold_dir / f'train_ids_{fold:03d}.csv', index=False)
        pd.DataFrame({'IID': test_ids}).to_csv(
            kfold_dir / f'test_ids_{fold:03d}.csv', index=False)


def generate_kfold_ids(hc_group, other_group, oversample_percentage=1,
                       n_splits=5, project_root=None) -> None:
    """The split of both groups' concatenation into
    outputs/kfold_analysis (data/loading.py:159-167 of the JAX package,
    without sklearn)."""
    root = Path(project_root) if project_root else Path.cwd()
    _write_fold_ids(root / 'outputs' / 'kfold_analysis',
                    pd.concat([hc_group, other_group]),
                    oversample_percentage, n_splits)


def generate_kfold_ids_endtoend(hc_group, other_group,
                                oversample_percentage=1, n_splits=5,
                                random_state=42, project_root=None) -> None:
    """The JAX package's data/loading.py:180-188 without sklearn: the same
    split as ``generate_kfold_ids``, written to
    outputs/kfold_analysis_endtoend (utils.py:19-42)."""
    root = Path(project_root) if project_root else Path.cwd()
    _write_fold_ids(root / 'outputs' / 'kfold_analysis_endtoend',
                    pd.concat([hc_group, other_group]),
                    oversample_percentage, n_splits,
                    random_state=random_state)


def generate_kfold_ids_with_unigroup(hc_group, other_group,
                                     oversample_percentage=1, n_splits=5,
                                     project_root=None) -> None:
    """Split HC only; every patient joins every test fold (utils.py:50-70,
    data/loading.py:170-177 of the JAX package)."""
    root = Path(project_root) if project_root else Path.cwd()
    _write_fold_ids(root / 'outputs' / 'kfold_analysis', hc_group,
                    oversample_percentage, n_splits,
                    test_extra=other_group['IID'])


def cliff_delta(X, Y, chunk: int = 4096) -> float:
    """Cliff's delta effect size (utils.py:97-109), with chunked numpy
    broadcasting in the place of the O(n*m) double loop, as the JAX
    package computes it (data/loading.py:191-202)."""
    X = np.asarray(X, dtype=np.float64).ravel()
    Y = np.asarray(Y, dtype=np.float64).ravel()
    total = 0.0
    for start in range(0, len(X), chunk):
        xs = X[start:start + chunk, None]
        total += np.sum(np.sign(xs - Y[None, :]))
    return total / (len(X) * len(Y))
