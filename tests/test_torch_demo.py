"""The port's demo projects (demo.py) against the JAX package's, on the CPU.

One synthetic ADNI cohort at the demo's size (90 controls, 40 + 40
patients, effect 0.8) is copied into two projects; the JAX demo builds one
and the port's demo (``device="cpu"``, the kernels' plain versions) the
other, both at SE-gPoE, -H 32 32 8, with the epochs cut to 3 and 2 folds.
The port replays JAX's init (PRNGKey(42)), its training noise and its
scoring noise (PRNGKey(1000 + fold)). Held: the same file set; the
normalized_* CSVs byte-equal and every other CSV and report number at rtol
1e-4 / atol 1e-5 (tests/test_torch_pipeline.py); each checkpoint's json
byte-equal and its parameters at the train CLI's trajectory bound (rtol
5e-3 / atol 1e-5, tests/test_torch_train_cli.py); ``cohort_latents``
against JAX's at rtol 1e-4 / atol 1e-5, for ``procedure=None`` on the
trained fold and for UCA-gPoE on a seeded four-modality model.
"""
import re
import shutil

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from multi_modal_normative_modeling_tpu import demo as jax_demo
from multi_modal_normative_modeling_tpu.data.synthetic import (
    make_synthetic_resource,
)
from multi_modal_normative_modeling_tpu.models import build_model as jax_build
from multi_modal_normative_modeling_tpu_torch import demo
from multi_modal_normative_modeling_tpu_torch.interop import (
    params_from_jax,
    read_flax_checkpoint,
)
from multi_modal_normative_modeling_tpu_torch.models import build_model
from tests.test_torch_pipeline import _jax_eps
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_train import jax_eps_replay
from tests.test_torch_train_cli import MODEL_DIR, _jax_init

EPOCHS, FOLDS = 3, 2
CSV_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=5e-3, atol=1e-5)
NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?")


def _files(root):
    return sorted(p.relative_to(root) for p in root.rglob("*")
                  if p.is_file())


@pytest.fixture(scope="module")
def projects(tmp_path_factory):
    base = tmp_path_factory.mktemp("demo")
    make_synthetic_resource(base / "cohort", "ADNI", n_hc=90,
                            n_disease={0: 40, 1: 40}, effect=0.8)
    for name in ("jax", "port"):
        shutil.copytree(base / "cohort", base / name)
    jax_demo.ensure_demo_project(base / "jax", epochs=EPOCHS,
                                 n_splits=FOLDS)
    demo.ensure_demo_project(base / "port", epochs=EPOCHS, n_splits=FOLDS,
                             device="cpu", init_fn=_jax_init,
                             eps_fn=jax_eps_replay, score_eps_fn=_jax_eps)
    return base / "jax", base / "port"


def test_the_port_demo_writes_the_jax_files(projects):
    jax_root, port_root = projects
    files = _files(jax_root)
    assert _files(port_root) == files
    assert sum(p.suffix == ".csv" for p in files) > 40
    assert {"result_baseline/result_multimodal.txt",
            "result_baseline/result_4.txt",
            "cvae_auc_and_std.csv"} <= {str(p) for p in files}


def test_the_port_demo_csvs_match_jax(projects):
    jax_root, port_root = projects
    csvs = [p for p in _files(jax_root) if p.suffix == ".csv"
            and p.parts[0] != "data"]
    for rel in csvs:
        if rel.name.startswith("normalized_"):
            assert ((port_root / rel).read_bytes()
                    == (jax_root / rel).read_bytes()), rel
            continue
        if rel.name == "cvae_auc_and_std.csv":
            np.testing.assert_allclose(
                np.loadtxt(port_root / rel, delimiter=","),
                np.loadtxt(jax_root / rel, delimiter=","), err_msg=str(rel),
                **CSV_TOL)
            continue
        ref = pd.read_csv(jax_root / rel)
        got = pd.read_csv(port_root / rel)
        assert list(got.columns) == list(ref.columns), rel
        assert got.shape == ref.shape, rel
        numeric = ref.select_dtypes("number").columns
        other = [c for c in ref.columns if c not in set(numeric)]
        pd.testing.assert_frame_equal(got[other], ref[other])
        np.testing.assert_allclose(got[numeric].to_numpy(np.float64),
                                   ref[numeric].to_numpy(np.float64),
                                   err_msg=str(rel), **CSV_TOL)


@pytest.mark.parametrize("report", ["result_multimodal.txt", "result_4.txt"])
def test_the_port_demo_reports_match_jax(projects, report):
    """The analysis stage's text reports: the same words, the numbers at
    the CSVs' bound."""
    jax_root, port_root = projects
    ref = (jax_root / "result_baseline" / report).read_text()
    got = (port_root / "result_baseline" / report).read_text()
    assert NUMBER.split(got) == NUMBER.split(ref)
    np.testing.assert_allclose(
        np.array(NUMBER.findall(got), float),
        np.array(NUMBER.findall(ref), float), **CSV_TOL)


@pytest.mark.parametrize("fold", range(FOLDS))
def test_the_port_demo_checkpoints_match_jax(projects, fold):
    jax_root, port_root = projects
    rel = f"{MODEL_DIR}/{fold:03d}"
    assert ((port_root / rel / "cVAE_model.json").read_bytes()
            == (jax_root / rel / "cVAE_model.json").read_bytes())
    got, _ = read_flax_checkpoint(port_root / rel)
    ref, _ = read_flax_checkpoint(jax_root / rel)
    a, b = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, **PARAM_TOL)


def test_cohort_latents_match_jax(projects):
    jax_root, port_root = projects
    ref, ref_labels = jax_demo.cohort_latents(
        jax_root, *jax_demo.load_fold_model(jax_root)[:2])
    model, params, config = demo.load_fold_model(port_root, device="cpu")
    assert config["input_dim_list"] == [90, 90, 90]
    got, labels = demo.cohort_latents(port_root, model, params)
    assert got.shape == ref.shape == (170, 8)
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_allclose(got, np.asarray(ref), **CSV_TOL)
    # the model's own weights when no params are given
    np.testing.assert_array_equal(
        demo.cohort_latents(port_root, model)[0], got)


def test_cohort_latents_of_a_uca_model_match_jax(projects):
    jax_root, _ = projects
    dims = [90, 90, 90, 270]
    jmodel = jax_build("cVAE_multimodal", dims, [32, 32], 8, 29, len(dims))
    tree = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(3)))
    ref, _ = jax_demo.cohort_latents(jax_root, jmodel, tree,
                                     procedure="UCA-gPoE")
    model = build_model("cVAE_multimodal", dims, [32, 32], 8, 29, len(dims),
                        folds=1)
    got, _ = demo.cohort_latents(jax_root, model, tree, procedure="UCA-gPoE")
    np.testing.assert_allclose(got, np.asarray(ref), **CSV_TOL)
    # fold-stacked: one latent per fold, the same model twice
    stacked = build_model("cVAE_multimodal", dims, [32, 32], 8, 29,
                          len(dims), folds=2)
    params_from_jax(jax.tree_util.tree_map(lambda a: np.stack([a, a]), tree),
                    stacked)
    both, _ = demo.cohort_latents(jax_root, stacked, procedure="UCA-gPoE")
    assert both.shape == (2, 170, 8)
    np.testing.assert_array_equal(both[0], got)
    np.testing.assert_array_equal(both[1], got)


def test_procedure_projects_run_once(projects, tmp_path):
    """ensure_procedure_projects builds one project per procedure; a second
    call reruns no stage (every file's mtime unchanged)."""
    jax_root, _ = projects
    for proc in ("SM_av45", "SE_gPoE", "UCA_gPoE"):
        shutil.copytree(jax_root / "data", tmp_path / proc / "data")
    roots = demo.ensure_procedure_projects(tmp_path, epochs=1,
                                           n_splits=FOLDS, device="cpu")
    assert list(roots) == ["SM-av45", "SE-gPoE", "UCA-gPoE"]
    for proc, root in roots.items():
        assert root == tmp_path / proc.replace("-", "_")
        assert (root / "result_baseline" / "result_multimodal.txt").exists()
        dev = root / "deviation/supervised_cvae/ADNI" / proc / "path_model"
        assert len([p for p in dev.iterdir() if p.is_dir()]) == {
            "SM-av45": 1, "SE-gPoE": 3, "UCA-gPoE": 4}[proc]
    stamps = {p: p.stat().st_mtime_ns for p in tmp_path.rglob("*")
              if p.is_file()}
    assert demo.ensure_procedure_projects(tmp_path, epochs=1,
                                          n_splits=FOLDS,
                                          device="cpu") == roots
    assert {p: p.stat().st_mtime_ns for p in tmp_path.rglob("*")
            if p.is_file()} == stamps


def test_the_demo_exits_without_a_card(monkeypatch, tmp_path):
    """device="cuda" (the default) with no CUDA device exits before any
    file is written, as the CLIs do; it does not run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        demo.ensure_demo_project(tmp_path / "p")
    with pytest.raises(SystemExit, match="no CUDA device"):
        demo.load_fold_model(tmp_path / "p")
    assert not (tmp_path / "p").exists()
