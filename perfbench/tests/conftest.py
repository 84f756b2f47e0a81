"""The benchmark's own tests (run with ``python -m pytest perfbench/tests``):
the repository's root on the path, and small shapes for runs on the CPU."""
import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# every width cut so that a run on the CPU takes seconds; the structure
# (modalities of two widths, hidden layers, folds, ragged nothing) kept
SMALL = {"input_dim_list": [9, 9, 9, 27], "hidden_dim": [11, 11],
         "latent_dim": 3, "c_dim": 5, "folds": 3, "epochs": 4,
         "batch_size": 16, "subjects_per_fold": 40}
SMALL_TRAFFIC = {"train_fused": {"pool": 2}}


def small_cell(workload: str) -> dict:
    """(bench, cfg, mix, limits) of a cell at small shapes."""
    from perfbench import spec

    bench = spec.load_benchmark()
    entry = spec.workload(bench, workload)
    cfg = copy.deepcopy(spec.config(bench, entry["config"]))
    cfg.update(SMALL)
    if cfg["name"] == "ppmi_se_gpoe":
        cfg.update(input_dim_list=[13, 13, 13])
    mix = dict(spec.traffic(entry["traffic"]))
    mix.update(SMALL_TRAFFIC[entry["traffic"]])
    return {"bench": bench, "cfg": cfg, "mix": mix,
            "limits": spec.limits(workload)}


@pytest.fixture
def small():
    return small_cell


def load_json(path):
    return json.loads(Path(path).read_text())
