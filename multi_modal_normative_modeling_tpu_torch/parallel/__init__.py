"""Fold stacking, the fold-parallel trainer and the mesh of ranks of the
port."""

from .folds import (  # noqa: F401
    MeshRun,
    MultiFoldTrainer,
    stack_fold_batches,
    stack_params,
    unstack_params,
)
from .mesh import fold_data_shardings, make_mesh  # noqa: F401
from .tensor import (  # noqa: F401
    fold_model_shardings,
    make_mesh3,
    tp_param_specs,
)
