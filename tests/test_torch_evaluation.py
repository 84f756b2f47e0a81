"""The port's analysis stage: ``evaluation/``, ``cli/group_analysis.py`` and
``cli/pipeline.py`` against scikit-learn and the JAX package's counterparts.

The port computes in numpy what the JAX package takes from
``sklearn.metrics`` (the machine with the GPU has no scikit-learn), so every
such function is held to scikit-learn's, exactly, on seeded and
hypothesis-drawn scores: ties, a single class and constant scores included.
The module's own functions are held to the JAX package's on the same arrays,
the report writers and the whole analysis stage to byte-equal files, and the
one-process pipeline to the three stages run apart.
"""
import argparse
import math
import shutil
import warnings
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import sklearn.metrics as skm
from hypothesis import given, settings, strategies as st

from multi_modal_normative_modeling_tpu.cli import (
    group_analysis as jax_group_analysis,
)
from multi_modal_normative_modeling_tpu.evaluation import (
    metrics as jax_metrics,
    reports as jax_reports,
)
from multi_modal_normative_modeling_tpu_torch.cli import (
    group_analysis,
    pipeline,
    test_supervised,
    train_supervised,
)
from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
    make_synthetic_resource,
)
from multi_modal_normative_modeling_tpu_torch.evaluation import (
    metrics,
    reports,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

METHODS = ["roc", "f1", "pr", "cost", "eer"]
REPORTS = ["result_baseline/result_multimodal.txt",
           "result_baseline/result_4.txt", "cvae_auc_and_std.csv"]


def _quiet(fn, *args):
    """fn(*args) without the undefined-metric warnings both sides raise; a
    ValueError (one class alone, in scikit-learn up to 1.6 and in the port)
    reads as nan, which is what later scikit-learn versions return."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return fn(*args)
        except ValueError:
            return float("nan")


def _same(got, want):
    """Exactly equal: arrays elementwise (nan == nan), scalars likewise."""
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got, want)
    assert np.array_equal(got, want, equal_nan=True), (got, want)


def _cases():
    """(name, labels, scores): continuous scores, heavy ties, constant
    scores, one class alone, the top score a negative, two samples."""
    rng = np.random.default_rng(0)
    out = []
    for n in (2, 5, 37, 200):
        labels = rng.integers(0, 2, n)
        labels[:2] = [0, 1]
        out.append((f"normal{n}", labels, rng.standard_normal(n)))
        out.append((f"ties{n}", labels, rng.integers(0, 4, n).astype(float)))
        out.append((f"shifted{n}", labels,
                    rng.standard_normal(n) + 1.5 * labels))
    labels = rng.integers(0, 2, 30)
    labels[:2] = [0, 1]
    out.append(("constant", labels, np.full(30, 0.25)))
    out.append(("all_positive", np.ones(12, int), rng.standard_normal(12)))
    out.append(("all_negative", np.zeros(12, int), rng.standard_normal(12)))
    out.append(("top_is_negative", np.array([0, 1, 1, 0, 1]),
                np.array([9.0, 1.0, 2.0, 0.5, 2.0])))
    out.append(("float_labels", np.array([0.0, 1.0, 1.0, 0.0]),
                np.array([0.1, 0.4, 0.35, 0.8])))
    return out


def _same_stats(got, want):
    assert list(got) == list(want)
    for key in want:
        _same(np.asarray(got[key]), np.asarray(want[key]))


CASES = _cases()
CASE_IDS = [name for name, _, _ in CASES]


def _check_curves(labels, scores):
    _same(_quiet(metrics.roc_curve, labels, scores),
          _quiet(skm.roc_curve, labels, scores))
    _same(_quiet(metrics.precision_recall_curve, labels, scores),
          _quiet(skm.precision_recall_curve, labels, scores))
    _same(_quiet(metrics.roc_auc_score, labels, scores),
          _quiet(skm.roc_auc_score, labels, scores))
    fpr, tpr, _ = _quiet(skm.roc_curve, labels, scores)
    _same(_quiet(metrics.auc, fpr, tpr), _quiet(skm.auc, fpr, tpr))


def _check_predictions(labels, predicted):
    for name in ("f1_score", "recall_score", "accuracy_score"):
        got = _quiet(getattr(metrics, name), labels, predicted)
        want = _quiet(getattr(skm, name), labels, predicted)
        assert isinstance(got, float), name
        _same(got, want)
    got = metrics.confusion_matrix(labels, predicted, labels=[0, 1])
    want = skm.confusion_matrix(labels, predicted, labels=[0, 1])
    assert got.dtype == want.dtype
    _same(got, want)


@pytest.mark.parametrize("name,labels,scores", CASES, ids=CASE_IDS)
def test_curves_equal_sklearn(name, labels, scores):
    _check_curves(labels, scores)


@pytest.mark.parametrize("name,labels,scores", CASES, ids=CASE_IDS)
def test_prediction_scores_equal_sklearn(name, labels, scores):
    labels = np.asarray(labels).astype(int)
    for threshold in (scores.min(), np.median(scores), scores.max() + 1.0):
        _check_predictions(labels, (scores >= threshold).astype(int))


@settings(max_examples=150, deadline=None, database=None)
@given(st.lists(st.tuples(st.integers(0, 1),
                          st.one_of(st.integers(-3, 3).map(float),
                                    st.floats(-1e6, 1e6, allow_nan=False))),
                min_size=2, max_size=60))
def test_curves_equal_sklearn_sweep(pairs):
    labels = np.array([p[0] for p in pairs])
    scores = np.array([p[1] for p in pairs], dtype=float)
    _check_curves(labels, scores)


@settings(max_examples=150, deadline=None, database=None)
@given(st.lists(st.tuples(st.integers(0, 1), st.integers(0, 1)), min_size=1,
                max_size=60))
def test_prediction_scores_equal_sklearn_sweep(pairs):
    _check_predictions(np.array([p[0] for p in pairs]),
                       np.array([p[1] for p in pairs]))


def test_what_sklearn_refuses_is_refused():
    with pytest.raises(ValueError, match="neither increasing nor decreasing"):
        metrics.auc([0.0, 1.0, 0.5], [0.0, 1.0, 1.0])
    with pytest.raises(ValueError, match="neither increasing nor decreasing"):
        skm.auc([0.0, 1.0, 0.5], [0.0, 1.0, 1.0])
    _same(metrics.auc([1.0, 0.5, 0.0], [1.0, 1.0, 0.0]),
          skm.auc([1.0, 0.5, 0.0], [1.0, 1.0, 0.0]))
    with pytest.raises(ValueError, match="At least 2 points"):
        metrics.auc([0.0], [1.0])
    for fn in (metrics.roc_curve, skm.roc_curve):
        with pytest.raises(ValueError):
            fn([2, 2, 3], [1.0, 2.0, 3.0])          # no positive label known
        with pytest.raises(ValueError):
            fn([0, 1, 1], [1.0, np.nan, 3.0])
    with pytest.raises(ValueError, match="Only one class"):
        metrics.roc_auc_score([1, 1, 1], [0.1, 0.2, 0.3])
    # the larger of two labels is the positive one
    _same(metrics.roc_auc_score([2, 3, 3, 2], [0.1, 0.4, 0.35, 0.8]),
          skm.roc_auc_score([2, 3, 3, 2], [0.1, 0.4, 0.35, 0.8]))
    for fn in (metrics.f1_score, skm.f1_score):
        with pytest.raises(ValueError):
            fn([0, 1, 2], [0, 1, 1])


# ---- evaluation.metrics against the JAX package's -------------------------

def _errors(seed, n_hc=30, n_patient=25, shift=0.8, ties=False):
    rng = np.random.default_rng(seed)
    hc = rng.gamma(2.0, 1.0, n_hc) + 1.0
    patient = rng.gamma(2.0, 1.0, n_patient) + 1.0 + shift
    if ties:
        hc, patient = np.round(hc), np.round(patient)
    return hc, patient


@pytest.mark.parametrize("ties", [False, True], ids=["continuous", "ties"])
@pytest.mark.parametrize("training_class", ["nm", "dm"])
@pytest.mark.parametrize("method", METHODS)
def test_classification_performance_equals_jax(method, training_class, ties):
    for seed in range(4):
        hc, patient = _errors(seed, ties=ties)
        got = _quiet(metrics.classification_performance, hc, patient,
                     training_class, None, method)
        want = _quiet(jax_metrics.classification_performance, hc, patient,
                      training_class, None, method)
        _same(tuple(got), tuple(want))
    # a threshold given by the caller
    _same(tuple(metrics.classification_performance(hc, patient,
                                                   training_class, 2.5)),
          tuple(jax_metrics.classification_performance(hc, patient,
                                                       training_class, 2.5)))


def test_classification_performance_refuses_what_jax_refuses():
    hc, patient = _errors(0)
    for module in (metrics, jax_metrics):
        with pytest.raises(ValueError, match="Unknown training_class"):
            module.classification_performance(hc, patient, "xx")
        with pytest.raises(ValueError, match="Unknown method"):
            module.classification_performance(hc, patient, "nm",
                                              method="xx")


@pytest.mark.parametrize("name", [
    "classification_thresholds", "find_best_threshold_by_f1",
    "find_best_threshold_by_pr", "find_best_threshold_by_cost",
    "find_best_threshold_by_eer", "binary_prediction_metrics"])
def test_metric_functions_equal_jax(name):
    for seed in range(4):
        hc, patient = _errors(seed, ties=bool(seed % 2))
        labels = np.concatenate([np.zeros_like(hc), np.ones_like(patient)])
        scores = np.concatenate([hc, patient])
        if name == "classification_thresholds":
            args = (hc, patient)
        elif name == "find_best_threshold_by_cost":
            args = (labels, scores, 1, 2)
        elif name == "binary_prediction_metrics":
            args = (labels.astype(int), (scores > 3.0).astype(int))
        else:
            args = (labels, scores)
        got = _quiet(getattr(metrics, name), *args)
        want = _quiet(getattr(jax_metrics, name), *args)
        if isinstance(want, dict):
            assert list(got) == list(want)
            got, want = tuple(got.values()), tuple(want.values())
        _same(got if isinstance(got, tuple) else (got,),
              want if isinstance(want, tuple) else (want,))


def test_binary_prediction_metrics_of_one_class():
    """A fold with one class alone: nan AUROC, the rest as the JAX
    package's."""
    labels, preds = np.zeros(6, int), np.array([0, 1, 0, 0, 1, 0])
    got = _quiet(metrics.binary_prediction_metrics, labels, preds)
    want = _quiet(jax_metrics.binary_prediction_metrics, labels, preds)
    assert math.isnan(got["auroc"]) and math.isnan(want["auroc"])
    _same(tuple(got.values()), tuple(want.values()))


# ---- evaluation.reports: byte-equal files ---------------------------------

def _report_args():
    return argparse.Namespace(procedure="UCA-gPoE", epochs=200,
                              oversample_percentage=1,
                              model="cVAE_multimodal",
                              hz_para_list=[110, 110, 10])


def _write_reports(module, root: Path):
    rng = np.random.default_rng(3)
    lists = [rng.uniform(0.5, 1.0, 5) for _ in range(10)]
    for compare in ("ADNI: 2 vs 0", "ADNI: 2 vs 1"):
        module.append_result_multimodal(root / "result_baseline", compare,
                                        _report_args(), *lists[:5])
    module.append_result_4(root / "result_baseline", _report_args(), *lists)
    module.write_auc_csvs(root, root / "cmp" / "02_vs_00", lists[0])
    frame = pd.DataFrame({"accuracy": lists[1], "auroc": lists[2]})
    module.append_endtoend_results(root / "results_endtoend.csv",
                                   _report_args(), frame)
    module.append_performance_metrics(root / "perf", *lists[0][:5],
                                      *lists[1][:5])
    return module.parse_result_auc(root, "2 vs 1")


def test_report_writers_write_the_jax_bytes(tmp_path):
    got = _write_reports(reports, tmp_path / "port")
    want = _write_reports(jax_reports, tmp_path / "jax")
    assert got == want
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert len(files) == 6
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == \
            (tmp_path / "jax" / rel).read_bytes(), rel


# ---- the analysis stage and the pipeline ----------------------------------

FLAGS = ["-R", "ADNI", "-P", "UCA-gPoE", "-K", "2", "-H", "8", "8", "4"]


def _files(root: Path):
    """What the chain writes, but the run log (time stamps) and the plots."""
    keep = {}
    for top in ("outputs", "deviation", "result_baseline"):
        for path in (root / top).rglob("*"):
            if path.is_file() and path.suffix in (".csv", ".txt", ".ckpt",
                                                  ".json"):
                keep[path.relative_to(root)] = path
    keep[Path("cvae_auc_and_std.csv")] = root / "cvae_auc_and_std.csv"
    return keep


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """A tiny cohort trained and scored by the port's stages run apart on
    the CPU (root ``apart``, then its analysis stage), a copy of the scored
    tree from before the analysis (``scored``), and the same cohort through
    the one-process pipeline (``piped``)."""
    apart = tmp_path_factory.mktemp("apart") / "project"
    make_synthetic_resource(apart, "ADNI", n_hc=40, n_disease={0: 16, 1: 16},
                            with_early_fusion=True)
    piped = tmp_path_factory.mktemp("piped") / "project"
    shutil.copytree(apart, piped)
    train_supervised.run(FLAGS + ["-E", "2", "--device", "cpu"],
                         project_root=apart)
    test_supervised.run(FLAGS + ["--device", "cpu"], project_root=apart)
    scored = tmp_path_factory.mktemp("scored") / "project"
    shutil.copytree(apart, scored)
    stats = group_analysis.run(FLAGS + ["-E", "2"], project_root=apart)
    piped_stats = pipeline.run(FLAGS + ["-E", "2", "--device", "cpu"],
                               project_root=piped)
    return {"apart": apart, "scored": scored, "piped": piped,
            "stats": stats, "piped_stats": piped_stats}


def test_pipeline_writes_what_the_stages_write_apart(chain):
    apart, piped = _files(chain["apart"]), _files(chain["piped"])
    assert set(piped) == set(apart)
    assert {Path(r) for r in REPORTS} <= set(apart)
    assert any(rel.name == "auc_rocs.csv" for rel in apart)
    for rel in sorted(apart):
        assert piped[rel].read_bytes() == apart[rel].read_bytes(), rel
    _same_stats(chain["piped_stats"], chain["stats"])


@pytest.mark.parametrize("method", METHODS)
def test_group_analysis_writes_the_jax_files(chain, method, tmp_path):
    roots = {}
    for side in ("port", "jax"):
        roots[side] = tmp_path / side
        shutil.copytree(chain["scored"], roots[side])
    flags = FLAGS + ["--threshold_method", method]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = group_analysis.run(flags, project_root=roots["port"])
        want = jax_group_analysis.run(flags, project_root=roots["jax"])
    _same_stats(got, want)
    assert len(got["auc"]) == 3
    assert np.isfinite(got["auc"]).all()
    assert all(0.0 <= a <= 1.0 for a in got["auc"])
    auc_rocs = sorted(p.relative_to(roots["jax"])
                      for p in roots["jax"].rglob("auc_rocs.csv"))
    assert len(auc_rocs) == 3
    for rel in [Path(r) for r in REPORTS] + auc_rocs:
        assert (roots["port"] / rel).read_bytes() == \
            (roots["jax"] / rel).read_bytes(), rel


def test_group_analysis_appends(chain, tmp_path):
    """The reports are append-only: a second run doubles the text files and
    rewrites the CSVs."""
    root = tmp_path / "project"
    shutil.copytree(chain["scored"], root)
    group_analysis.run(FLAGS, project_root=root)
    once = {rel: (root / rel).read_bytes() for rel in REPORTS}
    group_analysis.run(FLAGS, project_root=root)
    for rel in REPORTS[:2]:
        assert (root / rel).read_bytes() == once[rel] * 2
    assert (root / REPORTS[2]).read_bytes() == once[REPORTS[2]]


def test_pipeline_stages_and_flags(chain, tmp_path):
    parser = pipeline.build_parser()
    args = parser.parse_args(FLAGS)
    assert args.stages == "train,test,analyze" and args.device == "cuda"
    assert args.threshold_method == "roc" and not args.fused_inference
    # the analysis stage alone, on a scored tree
    root = tmp_path / "project"
    shutil.copytree(chain["scored"], root)
    stats = pipeline.run(FLAGS + ["-E", "2", "--stages", "analyze",
                                  "--fused_inference"], project_root=root)
    _same_stats(stats, chain["stats"])
    assert pipeline.run(FLAGS + ["--stages", " "], project_root=root) is None
    with pytest.raises(ValueError, match="unknown stages"):
        pipeline.run(FLAGS + ["--stages", "train,score"], project_root=root)


@pytest.mark.parametrize("flag", ["--ep_mesh=4,2", "--warmup_only",
                                  "--in_memory_fusion", "--resume",
                                  "--profile_dir=x", "--mesh=2,4"])
def test_pipeline_refuses_unported_flags_before_any_stage(flag, tmp_path,
                                                         chain):
    """Whatever stage would refuse the flag, the pipeline refuses it first,
    citing the ROADMAP item by name, and writes nothing. (--emit_latent,
    once in this list, is ported: tests/test_torch_latent.py; --resume is
    ported too, and refused without --checkpoint_every with the JAX
    package's message: tests/test_torch_resume.py; --in_memory_fusion is
    ported, and runs the chain: tests/test_torch_fusion.py.)"""
    if flag == "--in_memory_fusion":
        # ported: the chain runs on the early-fusion modality built in
        # memory, its CSV deleted, as the piped chain did from the CSV
        shutil.copytree(chain["apart"] / "data", tmp_path / "data")
        (tmp_path / "data" / "ADNI"
         / "early_fusion_modalities_ADNI.csv").unlink()
        stats = pipeline.run(FLAGS + ["-E", "2", "--device", "cpu", flag],
                             project_root=tmp_path)
        assert np.isfinite(stats["auc"]).all()
        rel = ("deviation/supervised_cvae/ADNI/UCA-gPoE/path_model/"
               "early_fusion_modalities_ADNI/"
               "reconstruction_error_early_fusion_modalities_ADNI.csv")
        np.testing.assert_allclose(
            pd.read_csv(tmp_path / rel)["Reconstruction error"],
            pd.read_csv(chain["piped"] / rel)["Reconstruction error"],
            rtol=1e-5, atol=1e-8)
        return
    match = r"ROADMAP\.md, .*'[A-Za-z]"
    if flag == "--resume":
        match = "--resume requires --checkpoint_every N"
    with pytest.raises(SystemExit, match=match):
        pipeline.run(FLAGS + ["--stages", "analyze", "--device", "cpu", flag],
                     project_root=tmp_path)
    assert not list(tmp_path.iterdir())
