"""ctypes wrapper for the native CSV writer (fastwrite.cpp).

``write_frame(path, frame)`` writes a pandas DataFrame byte-identically to
``frame.to_csv(path, index=False)`` for the dtypes the pipeline emits
(float64/float32/int64/str), using std::to_chars shortest-round-trip float
formatting (the representation pandas produces) across a thread pool.
Falls back to pandas when the library or a dtype isn't supported.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np
import pandas as pd

from ._build import load_native

_SRC = Path(__file__).parent / "fastwrite.cpp"
_LOCK = threading.Lock()
_LIB = None
_LIB_FAILED = False


def _build_lib():
    return load_native(_SRC, "fastwrite", _configure)


def _configure(lib) -> None:
    lib.fw_write_csv.restype = ctypes.c_int32
    lib.fw_write_csv.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int32,
    ]


def _lib():
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    with _LOCK:
        if _LIB is None and not _LIB_FAILED:
            try:
                _LIB = _build_lib()
            except Exception:
                _LIB_FAILED = True
    return _LIB


def fastwrite_available() -> bool:
    return _lib() is not None


def write_frame(path, frame: pd.DataFrame, n_threads: int = 16) -> bool:
    """Write ``frame`` as CSV (no index). Returns True if the native path
    handled it, False if the caller should fall back to pandas."""
    lib = _lib()
    if lib is None:
        return False

    # column NAMES need quoting too (an ROI name can carry a comma): the
    # same metacharacter screen as for string cells, or pandas handles it
    header_cells = [str(c) for c in frame.columns]
    header_joined = "\n".join(header_cells)
    if ("," in header_joined or '"' in header_joined
            or "\r" in header_joined or "\x00" in header_joined
            or header_joined.count("\n") != len(header_cells) - 1):
        return False

    n_rows = len(frame)
    n_cols = len(frame.columns)
    col_types = (ctypes.c_int32 * n_cols)()
    col_data = (ctypes.c_void_p * n_cols)()
    str_blobs = (ctypes.c_char_p * n_cols)()
    keepalive = []

    for i, (name, series) in enumerate(frame.items()):
        kind = series.dtype
        if kind == np.float64:
            arr = np.ascontiguousarray(series.to_numpy())
            col_types[i] = 0
            col_data[i] = arr.ctypes.data_as(ctypes.c_void_p)
        elif kind == np.float32:
            arr = np.ascontiguousarray(series.to_numpy())
            col_types[i] = 1
            col_data[i] = arr.ctypes.data_as(ctypes.c_void_p)
        elif kind == np.int64:
            arr = np.ascontiguousarray(series.to_numpy())
            col_types[i] = 2
            col_data[i] = arr.ctypes.data_as(ctypes.c_void_p)
        elif kind == object or pd.api.types.is_string_dtype(series.dtype):
            values = series.tolist()
            try:
                joined = "\n".join(values)
            except TypeError:
                return False  # non-str cells: pandas path
            # C-level scans of the single blob instead of per-value checks;
            # an embedded '\n' shows up as an extra separator in the count.
            # NUL would truncate the C-side strlen of the blob: pandas path.
            if ("," in joined or '"' in joined or "\r" in joined
                    or "\x00" in joined
                    or joined.count("\n") != len(values) - 1):
                return False  # needs quoting: pandas path
            blob = (joined + "\n").encode()
            col_types[i] = 3
            str_blobs[i] = blob
            keepalive.append(blob)
            continue
        else:
            return False
        keepalive.append(arr)

    header = ",".join(map(str, frame.columns)).encode()
    rc = lib.fw_write_csv(str(path).encode(), header, n_rows, n_cols,
                          col_types, col_data, str_blobs,
                          np.int32(n_threads))
    return rc == 0
