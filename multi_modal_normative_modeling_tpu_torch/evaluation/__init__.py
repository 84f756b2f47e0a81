"""Group-analysis metrics and report writers."""

from .metrics import (  # noqa: F401
    classification_performance,
    find_best_threshold_by_cost,
    find_best_threshold_by_eer,
    find_best_threshold_by_f1,
    find_best_threshold_by_pr,
)
from .reports import (  # noqa: F401
    append_endtoend_results,
    append_result_4,
    append_result_multimodal,
    write_auc_csvs,
)
