"""The port stands on its own: no module of
``multi_modal_normative_modeling_tpu_torch`` and not ``chip_smoke.py``
imports jax, flax or the JAX package, absolutely or relatively. Each file
is parsed with ``ast`` (nothing is executed), one case per file; the modules
that end the chain on the machine with the GPU (``evaluation/``,
``cli/group_analysis.py``, ``cli/pipeline.py``) and the supervised
variants' CLIs (``cli/nmpmcont.py``, ``cli/nmmlp.py``,
``cli/regression.py``) and the scoring surfaces (``infer/ensemble.py``,
``cli/score.py``, ``cli/serve.py``) and the grid engines and train state
(``cli/sweep_supervised.py``, ``cli/sweep_endtoend.py``,
``parallel/sweep.py``, ``train/checkpoints.py``), the bootstrap CLI and
the native data plane (``cli/bootstrap.py``, ``native/``, which imports
only the standard library, numpy and pandas), and the custom operators,
the classifier baseline, export and the report (``kernels/ops.py``,
``models/classifier.py``, ``data/splits.py``, ``viz.py``,
``cli/classifier_baseline.py``, ``cli/export.py``, ``cli/report.py``)
import no scikit-learn either, which that machine does not have, and those
three CLIs and the last seven no matplotlib; the last cases run the
whole chain, the three CLIs, and the scoring surfaces, in a process where importing any of them
fails."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "multi_modal_normative_modeling_tpu_torch"
JAX_PACKAGE = "multi_modal_normative_modeling_tpu"
FORBIDDEN = ("jax", "flax", "optax", JAX_PACKAGE)
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
# the analysis stage: no scikit-learn, at module level or inside a function
VARIANT_CLIS = [PORT / "cli" / f"{name}.py"
                for name in ("nmpmcont", "nmmlp", "regression")]
NO_SKLEARN = sorted((PORT / "evaluation").glob("*.py")) + [
    PORT / "cli" / "group_analysis.py", PORT / "cli" / "pipeline.py",
    PORT / "models" / "endtoend.py",
    PORT / "models" / "regression.py"] + VARIANT_CLIS + [
    PORT / "infer" / "ensemble.py", PORT / "cli" / "score.py",
    PORT / "cli" / "serve.py", PORT / "cli" / "sweep_supervised.py",
    PORT / "cli" / "sweep_endtoend.py", PORT / "parallel" / "sweep.py",
    PORT / "train" / "checkpoints.py", PORT / "cli" / "bootstrap.py",
    PORT / "cli" / "common.py", PORT / "infer" / "emitters.py"] + sorted(
    (PORT / "native").glob("*.py")) + [
    PORT / "kernels" / "ops.py", PORT / "models" / "classifier.py",
    PORT / "cli" / "classifier_baseline.py", PORT / "cli" / "export.py",
    PORT / "cli" / "report.py", PORT / "viz.py", PORT / "data" / "splits.py"]
# the classifier baseline, export and the report run on the card too: no
# matplotlib either
SLICE_12 = NO_SKLEARN[-7:]
# the native data plane: the standard library, numpy, pandas and itself
NATIVE = sorted((PORT / "native").glob("*.py"))
NATIVE_IMPORTS = ("__future__", "ctypes", "hashlib", "os", "subprocess",
                  "threading", "pathlib", "typing", "numpy", "pandas",
                  f"{PORT.name}.native")


def _absolute(path: Path, node: ast.ImportFrom, root: Path) -> str:
    """The absolute module an ImportFrom names, resolving leading dots
    against the file's own package under ``root``."""
    if node.level == 0:
        return node.module or ""
    parts = list(path.relative_to(root).with_suffix("").parts[:-1])
    if node.level > 1:
        parts = parts[:len(parts) - (node.level - 1)]
    return ".".join(parts + ([node.module] if node.module else []))


def imported_modules(path: Path, root: Path = ROOT):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom):
            base = _absolute(path, node, root)
            yield base, node.lineno
            for alias in node.names:
                yield f"{base}.{alias.name}", node.lineno


def _forbidden(module: str, names=FORBIDDEN) -> bool:
    return any(module == name or module.startswith(name + ".")
               for name in names)


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_import_of_jax_or_the_jax_package(path):
    bad = [(m, line) for m, line in imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", NO_SKLEARN,
                         ids=[str(p.relative_to(ROOT)) for p in NO_SKLEARN])
def test_the_analysis_stage_imports_no_sklearn(path):
    assert path.exists()
    bad = [(m, line) for m, line in imported_modules(path)
           if _forbidden(m, ("sklearn",))]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", VARIANT_CLIS,
                         ids=[str(p.relative_to(ROOT)) for p in VARIANT_CLIS])
def test_the_variant_clis_import_no_matplotlib(path):
    bad = [(m, line) for m, line in imported_modules(path)
           if _forbidden(m, ("matplotlib",))]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", SLICE_12,
                         ids=[str(p.relative_to(ROOT)) for p in SLICE_12])
def test_the_baseline_export_and_report_import_no_matplotlib(path):
    assert path.exists()
    bad = [(m, line) for m, line in imported_modules(path)
           if _forbidden(m, ("matplotlib",))]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", NATIVE,
                         ids=[str(p.relative_to(ROOT)) for p in NATIVE])
def test_native_imports_only_its_own_copy(path):
    """native/ is the port's own copy: it imports the standard library,
    numpy, pandas and itself, nothing of the JAX package."""
    bad = [(m, line) for m, line in imported_modules(path)
           if not _forbidden(m, NATIVE_IMPORTS)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    assert (PORT / "native" / "fastcsv.cpp").exists()


def test_the_walk_sees_an_import_inside_a_function(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    from sklearn.metrics import auc\n"
                     "    return auc\n")
    found = {m for m, _ in imported_modules(probe, tmp_path)}
    assert {"sklearn.metrics", "sklearn.metrics.auc"} <= found
    assert all(_forbidden(m, ("sklearn",)) for m in found)


def test_the_walk_sees_relative_and_absolute_imports(tmp_path):
    """The checker itself: a relative import that climbs out of the port
    into the JAX package, and plain absolute ones, are all caught."""
    pkg = tmp_path / PORT.name / "cli"
    pkg.mkdir(parents=True)
    probe = pkg / "probe.py"
    probe.write_text(
        "import jax.numpy as jnp\n"
        "from flax import serialization\n"
        f"from {JAX_PACKAGE}.data import loading\n"
        f"from ...{JAX_PACKAGE} import registry\n"
        "from .. import registry as ok\n"
        "import numpy\n")

    found = {m for m, _ in imported_modules(probe, tmp_path)}
    bad = {m for m in found if _forbidden(m)}
    assert {"jax.numpy", "flax", f"{JAX_PACKAGE}.data",
            f"{JAX_PACKAGE}", f"{JAX_PACKAGE}.registry"} <= bad, found
    assert f"{PORT.name}.registry" in found - bad
    assert not _forbidden(PORT.name) and not _forbidden("numpy")


_BLOCKED_CHAIN = """
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        root = name.split('.')[0]
        if root in ('jax', 'flax', 'optax', 'sklearn',
                    'multi_modal_normative_modeling_tpu'):
            raise ImportError('blocked for this check: ' + name)
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
import os
from pathlib import Path
from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
    make_synthetic_resource,
)
from multi_modal_normative_modeling_tpu_torch.cli import (
    group_analysis,
    pipeline,
    test_supervised,
    train_supervised,
)
os.chdir(sys.argv[2])
make_synthetic_resource(Path('.'), 'ADNI', n_hc=20, n_disease={0: 6, 1: 6})
flags = ['-R', 'ADNI', '-P', 'SE-MoE', '-K', '2', '-H', '8', '8', '4',
         '--device', 'cpu']
train_supervised.run(flags + ['-E', '2'])
test_supervised.run(flags)
stats = group_analysis.run(flags[:-2] + ['-E', '2'])
assert len(stats['auc']) == 3, stats
once = Path('result_baseline/result_4.txt').read_bytes()
again = pipeline.run(flags + ['-E', '2', '--stages', 'analyze'])
assert str(again) == str(stats), (again, stats)
assert Path('result_baseline/result_4.txt').read_bytes() == once * 2
bad = [m for m in sys.modules if m.split('.')[0] in
       ('jax', 'flax', 'optax', 'sklearn',
        'multi_modal_normative_modeling_tpu')]
assert not bad, bad
print('CHAIN_OK')
"""


def test_clis_run_where_the_jax_package_cannot_be_imported(tmp_path):
    """Train, score and analyse a tiny synthetic cohort on the CPU in a
    process whose import system refuses jax, flax, optax, sklearn and the
    JAX package."""
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_CHAIN, str(ROOT), str(tmp_path)],
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert "CHAIN_OK" in out.stdout
    assert list(tmp_path.glob("deviation/**/*.csv"))
    assert (tmp_path / "cvae_auc_and_std.csv").exists()
    assert len(list(tmp_path.rglob("auc_rocs.csv"))) == 3


_BLOCKED_VARIANTS = _BLOCKED_CHAIN.split("import os\n")[0] + """
import os
from pathlib import Path
# absent, as on the machine with the GPU: imports fail, find_spec says None
sys.modules['matplotlib'] = None
from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
    make_synthetic_resource,
)
from multi_modal_normative_modeling_tpu_torch.cli import (
    nmmlp,
    nmpmcont,
    regression,
)
os.chdir(sys.argv[2])
make_synthetic_resource(Path('.'), 'ADNI', n_hc=20, n_disease={0: 6, 1: 6},
                        with_fi=True)
flags = ['-R', 'ADNI', '-P', 'SE-MoE', '-K', '2', '-H', '8', '8', '4',
         '-E', '2', '--device', 'cpu']
metrics = nmpmcont.run(flags + ['-Layers', '8', '4'])
assert metrics.shape == (2, 5), metrics
stats = nmmlp.run(['all'] + flags)
assert stats['auc'] is not None, stats
scores = regression.run(flags)
assert len(scores) == 2, scores
bad = [m for m in sys.modules if m.split('.')[0] in
       ('jax', 'flax', 'optax', 'sklearn',
        'multi_modal_normative_modeling_tpu')]
assert not bad, bad
print('VARIANTS_OK')
"""


def test_variant_clis_run_without_jax_sklearn_or_matplotlib(tmp_path):
    """The three variant CLIs on a tiny synthetic cohort on the CPU, in a
    process that refuses jax, flax, optax, sklearn and the JAX package and
    has no matplotlib: every file but the loss plots."""
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_VARIANTS, str(ROOT), str(tmp_path)],
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert "VARIANTS_OK" in out.stdout
    assert (tmp_path / "results_endtoend.csv").exists()
    assert (tmp_path / "outputs" / "analysis_results"
            / "performance_metrics.txt").exists()
    assert len(list(tmp_path.glob("regression_outputs/*.npy"))) == 4
    assert len(list(tmp_path.glob(
        "outputs/kfold_analysis/supervised_cvae/*/cVAE_model.ckpt"))) == 2
    assert not list(tmp_path.rglob("*.png"))


_BLOCKED_SCORING = _BLOCKED_CHAIN.split("import os\n")[0] + """
import os
from pathlib import Path
sys.modules['matplotlib'] = None
import pandas as pd
from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
    make_synthetic_resource,
)
from multi_modal_normative_modeling_tpu_torch.cli import (
    score,
    serve,
    train_supervised,
)
os.chdir(sys.argv[2])
make_synthetic_resource(Path('.'), 'ADNI', n_hc=20, n_disease={0: 6, 1: 6})
flags = ['-R', 'ADNI', '-P', 'SE-PoE', '-K', '2', '--device', 'cpu']
train_supervised.run(flags + ['-E', '2', '-H', '8', '8', '4'])
pd.read_csv('data/ADNI/y.csv')[['IID']].to_csv('ids.csv', index=False)
out = score.run(flags + ['--ids', 'ids.csv', '--roi_output', 'roi.csv',
                         '--latent'])
assert len(out) == 32, out
svc = serve.ScoringService('ADNI', 'SE-PoE', n_splits=2, device='cpu')
got = svc.score_ids(list(out['participant_id'][:3]), roi=True, latent=True)
assert len(got['latent_deviation']) == 3, got
bad = [m for m in sys.modules if m.split('.')[0] in
       ('jax', 'flax', 'optax', 'sklearn',
        'multi_modal_normative_modeling_tpu')]
assert not bad, bad
print('SCORING_OK')
"""


def test_scoring_surfaces_run_without_jax_sklearn_or_matplotlib(tmp_path):
    """The score CLI and the scoring service on a tiny port-trained cohort
    on the CPU, in a process that refuses jax, flax, optax, sklearn and the
    JAX package and has no matplotlib."""
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_SCORING, str(ROOT), str(tmp_path)],
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert "SCORING_OK" in out.stdout
    assert _data_rows(tmp_path / "deviation_scores.csv") == 32
    assert _data_rows(tmp_path / "roi.csv") == 32
    assert (tmp_path / "outputs" / "kfold_analysis"
            / "serve_all_ids.csv").exists()


def _data_rows(path: Path) -> int:
    """Data rows of a CSV file (its lines less the header)."""
    return len(path.read_text().splitlines()) - 1


_BLOCKED_SWEEPS = _BLOCKED_CHAIN.split("import os\n")[0] + """
import os
from pathlib import Path
sys.modules['matplotlib'] = None
from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
    make_synthetic_resource,
)
from multi_modal_normative_modeling_tpu_torch.cli import (
    bootstrap,
    sweep_endtoend,
    sweep_supervised,
    train_supervised,
)
os.chdir(sys.argv[2])
make_synthetic_resource(Path('adhd'), 'ADHD', n_hc=20,
                        n_disease={0: 8, 2: 8})
records = sweep_supervised.run(
    ['-R', 'ADHD', '-K', '2', '--procedures', 'SE-gPoE', '--hz_grid',
     '8 8 4', '--epochs_list', '1', '2', '--device', 'cpu'],
    project_root=Path('adhd'))
assert len(records) == 2, records
make_synthetic_resource(Path('adni'), 'ADNI', n_hc=20,
                        n_disease={0: 6, 1: 6}, with_fi=True)
flags = ['-R', 'ADNI', '-P', 'SE-MoE', '-K', '2', '-H', '8', '8', '4',
         '--device', 'cpu']
results = sweep_endtoend.run(flags + ['-Layers', '8', '4', '-Margins', '1',
                                      '2', '-E', '2'],
                             project_root=Path('adni'))
assert len(results) == 4, results
train_supervised.run(flags + ['-E', '1', '--checkpoint_every', '1'],
                     project_root=Path('adni'))
train_supervised.run(flags + ['-E', '2', '--checkpoint_every', '1',
                              '--resume'], project_root=Path('adni'))
results = bootstrap.main(['all', '-B', '2', '-E', '1', '-H', '8', '8', '4',
                          '--device', 'cpu'], project_root=Path('adni'))
assert list(results) == ['2vs0', '2vs1'], results
bad = [m for m in sys.modules if m.split('.')[0] in
       ('jax', 'flax', 'optax', 'sklearn',
        'multi_modal_normative_modeling_tpu')]
assert not bad, bad
print('SWEEPS_OK')
"""


def test_sweeps_and_resume_run_without_jax_sklearn_or_matplotlib(tmp_path):
    """Both grid CLIs, a killed-and-resumed training run and the bootstrap
    chain (its early-fusion modality built in memory) on tiny
    synthetic cohorts on the CPU, in a process that refuses jax, flax,
    optax, sklearn and the JAX package and has no matplotlib."""
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_SWEEPS, str(ROOT), str(tmp_path)],
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert "SWEEPS_OK" in out.stdout
    assert (tmp_path / "adhd" / "outputs"
            / "sweep_supervised_results.json").exists()
    assert (tmp_path / "adni" / "results_endtoend.csv").read_text().count(
        "Namespace(") == 4
    state = tmp_path / "adni" / "outputs/kfold_analysis/supervised_cvae"
    assert (state / "train_state.json").read_text() == '{"epoch": 2}'
    assert (tmp_path / "adni" / "bootstrap_auc.csv").exists()
    assert not list(tmp_path.rglob("*.png"))
