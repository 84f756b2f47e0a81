"""Fold stacking and the fold-parallel trainer of the port."""

from .folds import (  # noqa: F401
    MultiFoldTrainer,
    stack_fold_batches,
    stack_params,
    unstack_params,
)
