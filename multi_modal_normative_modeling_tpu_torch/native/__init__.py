"""Native (C++) data-plane components, loaded via ctypes: the port's own
copy of the JAX package's native/ (the ``.cpp`` files byte for byte)."""

from .fastcsv import FastCSV, fastcsv_available, read_feature_matrix  # noqa: F401
