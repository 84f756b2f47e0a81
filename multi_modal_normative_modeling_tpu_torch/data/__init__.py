"""Data layer: CSV ingestion, k-fold id generation, preprocessing,
synthetic cohorts (counterpart of data/__init__.py)."""

from .loading import (  # noqa: F401
    cliff_delta,
    generate_kfold_ids,
    generate_kfold_ids_endtoend,
    generate_kfold_ids_with_unigroup,
    load_dataset,
    load_demographic_data,
)
from .preprocess import (  # noqa: F401
    fit_robust_scaler,
    one_hot_covariates,
    RobustScalerParams,
)
