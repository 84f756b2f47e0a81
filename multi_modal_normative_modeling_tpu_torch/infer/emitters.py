"""Deviation CSV emitters.

Writes the five per-(fold, modality) CSVs of the reference test script
(multimodal_kfold_test_cvae_supervised.py:116-154) and the concatenated
all-fold copies under deviation/<model>/<resource>/<procedure>/path_model/
(test:156-178), with the exact column layouts of the checked-in goldens:

  normalized_<mod>.csv                 participant_id,DIA,AGE,PTGENDER,<roi...>
  reconstruction_<mod>.csv             same prefix, reconstructed values
  reconstruction_error_<mod>.csv       prefix + 'Reconstruction error' scalar
  reconstruction_error_roi_<mod>.csv   prefix + per-ROI squared error
  deviation_as_feature_importance_<mod>.csv  ROI columns renamed '1'..'N'
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import pandas as pd

from .deviation import reconstruction_deviation_roi


def write_csv(path, frame: pd.DataFrame) -> None:
    """frame.to_csv(path, index=False), through the native multithreaded
    writer when possible (byte-identical output; native/fastwrite.cpp)."""
    try:
        from ..native.fastwrite import write_frame

        if write_frame(path, frame):
            return
    except Exception:
        pass
    frame.to_csv(path, index=False)


class DeviationEmitter:
    """Accumulates per-fold frames and writes per-fold + combined CSVs.

    Writes go through a small thread pool, overlapping CSV emission with the
    next fold's frame construction; ``emit_combined`` joins and re-raises
    any write error."""

    def __init__(self, dataset_names: Sequence[str], write_threads: int = 4):
        from concurrent.futures import ThreadPoolExecutor

        self.dataset_names = list(dataset_names)
        self._pool = ThreadPoolExecutor(max_workers=max(1, write_threads))
        self._futures: list = []
        self._all: Dict[str, Dict[str, List[pd.DataFrame]]] = {
            kind: {name: [] for name in self.dataset_names}
            for kind in (
                "normalized",
                "reconstruction",
                "reconstruction_error",
                "reconstruction_error_roi",
                "deviation_as_feature_importance",
            )
        }

    def emit_fold(self, fold_model_dir, dataset_name: str,
                  columns_name: Sequence[str], covariates_df: pd.DataFrame,
                  test_data: np.ndarray, prediction: np.ndarray,
                  deviation: np.ndarray) -> None:
        """Write the five CSVs for one (fold, modality) and remember them for
        the combined emit. ``covariates_df`` must carry participant_id, DIA,
        AGE, PTGENDER in test-row order."""
        out_dir = Path(fold_model_dir) / dataset_name
        out_dir.mkdir(parents=True, exist_ok=True)
        columns_name = list(columns_name)
        prefix = covariates_df[
            ["participant_id", "DIA", "AGE", "PTGENDER"]
        ].reset_index(drop=True)

        def with_features(values: np.ndarray, columns=columns_name):
            features = pd.DataFrame(np.asarray(values), columns=columns)
            return pd.concat([prefix, features], axis=1)

        normalized = with_features(test_data)
        reconstruction = with_features(prediction)
        error = prefix.copy()
        error["Reconstruction error"] = np.asarray(deviation)
        roi = with_features(reconstruction_deviation_roi(test_data,
                                                         prediction))
        numbered = list(map(str, range(1, len(columns_name) + 1)))
        importance = roi.rename(columns=dict(zip(columns_name, numbered)))

        frames = {
            "normalized": normalized,
            "reconstruction": reconstruction,
            "reconstruction_error": error,
            "reconstruction_error_roi": roi,
            "deviation_as_feature_importance": importance,
        }
        # fail fast on writes that already finished with an error (ENOSPC,
        # permissions): surface them before the next fold's device compute
        # instead of only at the emit_combined join
        for future in self._futures:
            if future.done():
                future.result()
        for kind, frame in frames.items():
            self._futures.append(self._pool.submit(
                write_csv, out_dir / f"{kind}_{dataset_name}.csv", frame))
            self._all[kind][dataset_name].append(frame)

    def emit_combined(self, deviation_dir) -> None:
        """Concatenate all folds per modality (test:156-178); joins all
        pending per-fold writes first."""
        for dataset_name in self.dataset_names:
            out_dir = Path(deviation_dir) / dataset_name
            out_dir.mkdir(parents=True, exist_ok=True)
            for kind, per_dataset in self._all.items():
                frames = per_dataset[dataset_name]
                if not frames:
                    continue
                combined = pd.concat(frames, ignore_index=True)
                self._futures.append(self._pool.submit(
                    write_csv, out_dir / f"{kind}_{dataset_name}.csv",
                    combined))
        self.close()

    def close(self) -> None:
        """Join EVERY pending write, shut the pool down, then surface
        failures: a single failed file (e.g. ENOSPC) must not leak running
        writers or hide later failures. Idempotent; use it (or the context
        manager) on abort paths that never reach emit_combined, so already-
        submitted per-fold writes cannot fail silently."""
        errors = []
        try:
            for future in self._futures:
                try:
                    future.result()
                except Exception as exc:
                    errors.append(exc)
        finally:
            self._futures.clear()
            self._pool.shutdown(wait=True)
        if errors:
            raise RuntimeError(
                f"{len(errors)} deviation CSV write(s) failed; first: "
                f"{errors[0]!r}") from errors[0]

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
            return False
        try:  # don't mask the in-flight exception with a write error
            self.close()
        except Exception:
            pass
        return False
