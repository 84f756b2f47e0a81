"""ctypes wrapper around the C++ fastcsv loader (fastcsv.cpp).

Builds the shared library on first use with g++ (into native/_build/,
keyed by a source hash) and falls back to pandas transparently when no
compiler is available — the Python API is identical either way.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ._build import load_native

_SRC = Path(__file__).parent / "fastcsv.cpp"
_LOCK = threading.Lock()
_LIB = None
_LIB_FAILED = False


def _build_lib() -> Optional[ctypes.CDLL]:
    return load_native(_SRC, "fastcsv", _configure)


def _configure(lib) -> None:
    lib.fc_open.restype = ctypes.c_void_p
    lib.fc_open.argtypes = [ctypes.c_char_p]
    lib.fc_num_rows.restype = ctypes.c_int64
    lib.fc_num_rows.argtypes = [ctypes.c_void_p]
    lib.fc_num_cols.restype = ctypes.c_int64
    lib.fc_num_cols.argtypes = [ctypes.c_void_p]
    lib.fc_col_index.restype = ctypes.c_int32
    lib.fc_col_index.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.fc_fill.restype = ctypes.c_int32
    lib.fc_fill.argtypes = [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                            ctypes.POINTER(ctypes.c_double), ctypes.c_int32]
    lib.fc_read_strings.restype = ctypes.c_int64
    lib.fc_read_strings.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                    ctypes.c_char_p, ctypes.c_int64]
    lib.fc_close.restype = None
    lib.fc_close.argtypes = [ctypes.c_void_p]


def _lib() -> Optional[ctypes.CDLL]:
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


def fastcsv_available() -> bool:
    return _lib() is not None


class FastCSV:
    """Handle to a parsed CSV file (header + row index in C++)."""

    def __init__(self, path):
        lib = _lib()
        if lib is None:
            raise RuntimeError("fastcsv native library unavailable")
        self._lib = lib
        self._handle = lib.fc_open(str(path).encode())
        if not self._handle:
            raise IOError(f"fastcsv: cannot open {path}")
        self.n_rows = int(lib.fc_num_rows(self._handle))
        self.n_cols = int(lib.fc_num_cols(self._handle))

    def col_index(self, name: str) -> int:
        return int(self._lib.fc_col_index(self._handle, name.encode()))

    # cgroup containers often report 1 CPU while real cores are schedulable;
    # measured: 16 threads parse a 200MB frame 15x faster than 1 even with
    # nproc==1 here. Default high; the pool is per-call and short-lived.
    DEFAULT_THREADS = 16

    def read_columns(self, columns: Sequence[str],
                     n_threads: int = 0) -> np.ndarray:
        if n_threads == 0:
            n_threads = self.DEFAULT_THREADS
        idx = np.empty(len(columns), dtype=np.int32)
        for j, name in enumerate(columns):
            ci = self.col_index(name)
            if ci < 0:
                raise KeyError(f"fastcsv: column not found: {name}")
            idx[j] = ci
        out = np.empty((self.n_rows, len(columns)), dtype=np.float64)
        rc = self._lib.fc_fill(
            self._handle,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            np.int32(len(columns)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            np.int32(n_threads),
        )
        if rc != 0:
            raise RuntimeError(f"fastcsv: fill failed ({rc})")
        return out

    def read_string_column(self, name: str) -> List[str]:
        ci = self.col_index(name)
        if ci < 0:
            raise KeyError(f"fastcsv: column not found: {name}")
        needed = self._lib.fc_read_strings(self._handle, np.int32(ci), None, 0)
        buf = ctypes.create_string_buffer(int(needed))
        self._lib.fc_read_strings(self._handle, np.int32(ci), buf, needed)
        raw = buf.raw[:needed].decode()
        cells = raw.split("\n")[:-1]
        if len(cells) != self.n_rows:
            # a string cell embeds a newline: the '\n'-joined transport is
            # ambiguous. Refuse rather than mis-align rows; callers fall
            # back to pandas (cli/common.py latches the reason).
            raise RuntimeError(
                f"fastcsv: string column {name!r} has embedded newlines "
                f"({len(cells)} cells for {self.n_rows} rows)")
        return cells

    def close(self):
        if self._handle:
            self._lib.fc_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def read_feature_matrix(path, columns: Sequence[str],
                        id_column: str = "IID",
                        n_threads: int = 0
                        ) -> Tuple[List[str], np.ndarray]:
    """(ids, features[rows, len(columns)]) — native when possible, pandas
    otherwise."""
    if fastcsv_available():
        f = FastCSV(path)
        try:
            ids = f.read_string_column(id_column)
            data = f.read_columns(columns, n_threads)
            return ids, data
        except RuntimeError:
            # e.g. an id cell embeds a newline ('\n'-joined transport is
            # ambiguous — read_string_column refuses): honor the documented
            # contract and fall back to pandas, which parses such files fine
            pass
        finally:
            f.close()
    import pandas as pd

    frame = pd.read_csv(path)
    return list(frame[id_column].astype(str)), frame[list(columns)].values
