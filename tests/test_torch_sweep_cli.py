"""The port's grid CLIs against the JAX package's, on the CPU.

``sweep_supervised`` on a tiny synthetic ADHD cohort (30 controls, 12 + 12
patients, 2 folds, SM-sMRI and SE-gPoE, one hidden shape, epochs 2 and 3,
two lr pairs: 8 records, 4 computed points, 2 training runs), the port's
run from the JAX init with the JAX training and scoring noise replayed
(``jax_eps_replay``, PRNGKey(1000 + fold)): the same records in the same
order, each deduped record carrying its twin's statistics, the statistics
at the pipeline's tolerance (rtol 1e-4 / atol 1e-5,
tests/test_torch_pipeline.py), the run log's events, and as many
result_baseline blocks. The last computed point's checkpoints, deviation
CSVs and statistics equal those of the port's own train, test and
analysis stages run alone at that point, bit for bit.

``sweep_endtoend`` on a tiny ADNI cohort with its FI column (2 margins x 2
contrastive weights, 2 folds, 2 epochs), from the JAX init with the JAX
draws replayed: results_endtoend.csv against the JAX CLI's (numbers rtol
1e-4 / atol 1e-5, tests/test_torch_variant_cli.py), and the block of one
config against the port's nmpmcont run alone at it.

Each flag that is not ported exits citing its ROADMAP.md item, before any
file is written.
"""
import json
import re
import shutil
import warnings

import jax
import numpy as np
import pytest

from multi_modal_normative_modeling_tpu.cli import (
    sweep_endtoend as jax_sweep_endtoend,
    sweep_supervised as jax_sweep,
)
from multi_modal_normative_modeling_tpu.data.synthetic import (
    make_synthetic_resource,
)
from multi_modal_normative_modeling_tpu_torch.cli import (
    group_analysis,
    nmpmcont,
    sweep_endtoend,
    sweep_supervised,
    test_supervised,
    train_supervised,
)
from tests.test_torch_pipeline import _jax_eps
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_train import jax_eps_replay
from tests.test_torch_train_cli import _jax_init
from tests.test_torch_variant_cli import JAX_MODELS, _draws
from tests.test_torch_variant_cli import _jax_init as _variant_init

MODEL_DIR = "outputs/kfold_analysis/supervised_cvae"
SWEEP = ["-R", "ADHD", "-K", "2", "--procedures", "SM-sMRI", "SE-gPoE",
         "--hz_grid", "16 16 4", "--epochs_list", "2", "3",
         "--lr_grid", "1e-4:5e-3,1e-5:5e-3"]
GRID = ["-R", "ADNI", "-P", "SE-MoE", "-K", "2", "-H", "16", "16", "4",
        "-Layers", "16", "8", "-Margins", "0.5", "1", "-Weightcontrastives",
        "0.1", "1", "-E", "2"]
TOL = dict(rtol=1e-4, atol=1e-5)


def _copy_data(src, dst):
    shutil.copytree(src / "data", dst / "data")
    return dst


@pytest.fixture(scope="module")
def supervised(tmp_path_factory):
    base = tmp_path_factory.mktemp("sweep_supervised")
    make_synthetic_resource(base / "jax", "ADHD", n_hc=30,
                            n_disease={0: 12, 2: 12})
    port = _copy_data(base / "jax", base / "port")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jax_sweep.run(SWEEP, project_root=base / "jax")
        args = sweep_supervised.build_parser().parse_args(
            SWEEP + ["--device", "cpu"])
        got = sweep_supervised.main(args, project_root=port,
                                    init_fn=_jax_init,
                                    eps_fn=jax_eps_replay,
                                    score_eps_fn=_jax_eps)
    return base, ref, got


def test_sweep_records_match_the_jax_sweep(supervised):
    base, ref, got = supervised
    assert len(got) == len(ref) == 8
    summary = (base / "port" / "outputs"
               / "sweep_supervised_results.json").read_text()
    assert summary == json.dumps(got, indent=1)
    for a, b in zip(got, ref):
        assert set(a) == set(b)
        for k in a:
            if k != "stats":
                assert a[k] == b[k], k
        assert set(a["stats"]) == set(b["stats"])
        for k, v in a["stats"].items():
            np.testing.assert_allclose(v, b["stats"][k], err_msg=k, **TOL)
    # the second lr pair is deduped onto the first: its twin's stats
    for twin, deduped in zip(got[::2], got[1::2]):
        assert deduped["deduped_from"] == {"base_learning_rate": 1e-4,
                                           "max_learning_rate": 5e-3}
        assert deduped["stats"] == twin["stats"]
        assert all(np.isfinite(v) and 0.0 <= v <= 1.0
                   for v in twin["stats"]["auc"])


def test_sweep_writes_the_jax_run_log_and_reports(supervised):
    base, _, _ = supervised
    kinds = {}
    for side in ("jax", "port"):
        events = [json.loads(line) for line in
                  (base / side / MODEL_DIR / "run_log.jsonl")
                  .read_text().splitlines()]
        kinds[side] = [e["event"] for e in events]
        assert events[0]["points"] == 8 and events[0]["runs"] == 2
    assert kinds["port"] == kinds["jax"] == (
        ["sweep_start"] + ["point_done"] * 4 + ["sweep_end"])
    files = {side: sorted(p.relative_to(base / side) for p in
                          (base / side / "result_baseline").rglob("*"))
             for side in ("jax", "port")}
    assert files["port"] == files["jax"] and files["jax"]
    for rel in files["jax"]:
        if (base / "jax" / rel).is_file():
            lines = [(base / side / rel).read_text().splitlines()
                     for side in ("jax", "port")]
            assert len(lines[0]) == len(lines[1]) > 0, rel
    # one block per computed point
    blocks = (base / "port" / "result_baseline" / "result_4.txt").read_text()
    assert blocks.count("Experiment settings:") == 4


def test_last_point_equals_the_standalone_chain(supervised, tmp_path):
    base, _, got = supervised
    last = got[-2]
    assert (last["procedure"], last["epochs"]) == ("SE-gPoE", 3)
    alone = _copy_data(base / "jax", tmp_path / "alone")
    args = sweep_supervised._point_args(
        sweep_supervised.build_parser().parse_args(
            SWEEP + ["--device", "cpu"]), "SE-gPoE", [16, 16, 4], 3, 1e-4,
        5e-3)
    args.batch_size, args.fold_parallel = 256, True
    train_supervised.main(args, project_root=alone, init_fn=_jax_init,
                          eps_fn=jax_eps_replay)
    test_supervised.main(args, project_root=alone, eps_fn=_jax_eps)
    stats = group_analysis.main(args, project_root=alone)
    assert json.dumps({k: [float(x) for x in v]
                       for k, v in stats.items()}) == json.dumps(last["stats"])
    port = base / "port"
    compared = 0
    for sub in (MODEL_DIR, "deviation/supervised_cvae/ADHD/SE-gPoE"):
        for path in sorted((alone / sub).rglob("*")):
            if path.suffix in (".ckpt", ".csv"):
                rel = path.relative_to(alone)
                assert (port / rel).read_bytes() == path.read_bytes(), rel
                compared += 1
    assert compared > 2


@pytest.fixture(scope="module")
def endtoend(tmp_path_factory):
    base = tmp_path_factory.mktemp("sweep_endtoend")
    make_synthetic_resource(base / "jax", "ADNI", n_hc=30,
                            n_disease={0: 11, 1: 10}, with_fi=True)
    port = _copy_data(base / "jax", base / "port")
    hooks = dict(init_fn=_variant_init(JAX_MODELS["nmpmcont"]),
                 draws_fn=_draws())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_sweep_endtoend.run(GRID, project_root=base / "jax")
        args = sweep_endtoend.build_parser().parse_args(
            GRID + ["--device", "cpu"])
        sweep_endtoend.common.apply_post_parse_defaults(
            args, default_procedure="SE-MoE")
        results = sweep_endtoend.main(args, project_root=port, **hooks)
        alone = _copy_data(base / "jax", base / "alone")
        args = nmpmcont.build_parser().parse_args(
            GRID[:13] + ["-Margin", "1", "-Weightcontrastive", "0.1", "-E",
                         "2", "--device", "cpu"])
        nmpmcont.common.apply_post_parse_defaults(
            args, default_procedure="SE-MoE")
        nmpmcont.main(args, project_root=alone, **hooks)
    return base, results


NUMBER = re.compile(r"-?\d+\.\d+|nan")


def _blocks(path):
    """results_endtoend.csv as (args line, metric lines) blocks."""
    lines = path.read_text().split("\n")
    starts = [i for i, line in enumerate(lines)
              if line.startswith("Namespace(")]
    return [(lines[i], lines[i + 1:i + 6]) for i in starts]


def _close_lines(got, ref):
    for a, b in zip(got, ref):
        assert NUMBER.sub("#", a) == NUMBER.sub("#", b)
        np.testing.assert_allclose([float(v) for v in NUMBER.findall(a)],
                                   [float(v) for v in NUMBER.findall(b)],
                                   **TOL)


def test_endtoend_sweep_matches_the_jax_cli(endtoend):
    base, results = endtoend
    assert sorted(results) == [(0.5, 0.1), (0.5, 1.0), (1.0, 0.1),
                               (1.0, 1.0)]
    ref = (base / "jax" / "results_endtoend.csv").read_text().split("\n")
    got = (base / "port" / "results_endtoend.csv").read_text().split("\n")
    assert len(got) == len(ref) == 4 * (1 + 5 + 3) + 1
    # the args lines: the JAX CLI's flags plus --device
    got = [a.replace("device='cpu', ", "") for a in got]
    for a, b in zip(got, ref):
        if b.startswith("Namespace("):
            assert a == b
    _close_lines(got, ref)


def test_one_config_of_the_grid_equals_nmpmcont_alone(endtoend):
    base, _ = endtoend
    blocks = _blocks(base / "port" / "results_endtoend.csv")
    (alone_args, alone), = _blocks(base / "alone" / "results_endtoend.csv")
    config = [lines for head, lines in blocks
              if "margin=1.0," in head and "weightcontrastive=0.1)" in head]
    assert len(blocks) == 4 and len(config) == 1
    assert "margin=1.0," in alone_args
    _close_lines(config[0], alone)


SWEEP_FLAGS = [
    ("--mesh", "2,2", "'Multi-device'"),
    ("--ep_mesh", "2,2,2", "'Multi-device'"),
    ("--packed_xla", None, "'Packed layout' and 'Grouped layout'"),
    ("--precision", "bf16", "'Trainer'"),
    ("--in_memory_fusion", None, None),   # ported: the grid runs
]


@pytest.mark.parametrize("flag,value,item", SWEEP_FLAGS,
                         ids=[f[0] for f in SWEEP_FLAGS])
def test_sweep_unported_flags_exit_citing_their_item(flag, value, item,
                                                     tmp_path):
    argv = SWEEP + ["--device", "cpu", flag] + ([value] if value else [])
    if item is None:
        # a UCA procedure's early-fusion modality built in memory at every
        # grid point: its CSV is not in this cohort
        make_synthetic_resource(tmp_path, "ADHD", n_hc=30,
                                n_disease={0: 12, 2: 12})
        records = sweep_supervised.run(argv + ["--procedures", "UCA-gPoE"],
                                       project_root=tmp_path)
        assert len(records) == 4
        assert all(np.isfinite(r["stats"]["auc"]).all() for r in records)
        fused = "early_fusion_modalities_ADHD"
        assert (tmp_path / "deviation" / "supervised_cvae" / "ADHD"
                / "UCA-gPoE" / "path_model" / fused
                / f"reconstruction_error_{fused}.csv").exists()
        return
    with pytest.raises(SystemExit, match=f"ROADMAP.md, queue 1 items? "
                                         f"{re.escape(item)}"):
        sweep_supervised.run(argv, project_root=tmp_path)
    assert not list(tmp_path.iterdir())


def test_endtoend_sweep_mesh_exits_citing_multi_device(tmp_path):
    with pytest.raises(SystemExit, match="ROADMAP.md, queue 1 item "
                                         "'Multi-device'"):
        sweep_endtoend.run(GRID + ["--device", "cpu", "--mesh", "2,2"],
                           project_root=tmp_path)
    assert not list(tmp_path.iterdir())


def test_sweep_parsers_default_to_cuda():
    assert sweep_supervised.build_parser().parse_args([]).device == "cuda"
    assert sweep_endtoend.build_parser().parse_args([]).device == "cuda"
    args = sweep_supervised.build_parser().parse_args(["--no_fused_heads"])
    assert args.no_fused_heads
