"""CSV ingestion for the port's CLIs (counterpart of data/loading.py).

Behavioral parity with the reference data layer:
  * ``load_dataset`` / ``load_demographic_data``  - utils.py:112-168 (merge a
    modality CSV with the demographic table on IID, honoring the three id
    formats Run_ID / Session_ID / plain IID)
  * ``fast_inner_merge``: the numpy row-map join both of them use.

The k-fold id files are written by ``cli/common.kfold_split`` (a copy of
sklearn's KFold shuffle, so the port needs no sklearn).
"""
from __future__ import annotations

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
