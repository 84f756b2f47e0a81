"""Fold-parallel helpers of the port."""

from .folds import stack_params  # noqa: F401
