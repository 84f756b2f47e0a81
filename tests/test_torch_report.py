"""The experiment report (cli/report.py) and the tables of viz.py of the
port against the JAX package's, on the CPU: the markdown byte for byte on
one project's artifacts (the port's chain on a small synthetic cohort),
and the ROI-deviation and AUC-summary frames equal (tests/test_aux.py:91,
:122, tests/test_misc_paths.py:71)."""
import numpy as np
import pandas as pd
import pytest

from multi_modal_normative_modeling_tpu import viz as jax_viz
from multi_modal_normative_modeling_tpu.cli import report as jax_report
from multi_modal_normative_modeling_tpu_torch import viz
from multi_modal_normative_modeling_tpu_torch.cli import pipeline, report
from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
    make_synthetic_resource,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

FLAGS = ["-R", "ADNI", "-P", "SE-MoE", "-E", "2", "-K", "2", "-H", "8", "8",
         "4", "--device", "cpu"]


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    root = tmp_path_factory.mktemp("report_project")
    make_synthetic_resource(root, "ADNI", n_hc=24, n_disease={0: 8, 1: 8},
                            effect=1.2)
    pipeline.run(FLAGS, project_root=root)
    return root


def test_report_markdown_byte_equal(project, tmp_path):
    want = jax_report.generate_report(project, "ADNI", "SE-MoE",
                                      out_path=tmp_path / "jax.md")
    got = report.generate_report(project, "ADNI", "SE-MoE",
                                 out_path=tmp_path / "port.md")
    assert got == want
    assert (tmp_path / "port.md").read_bytes() == (
        tmp_path / "jax.md").read_bytes()
    for section in ("# Experiment report", "mean ROC-AUC",
                    "result_multimodal.txt", "Top deviating ROIs"):
        assert section in got, section
    assert got.count("### ") == 3   # one table per modality


def test_report_cli_equal(project, tmp_path, capsys):
    report.run(["-R", "ADNI", "-P", "SE-MoE", "--out",
                str(tmp_path / "port.md")], project_root=project)
    port_out = capsys.readouterr().out
    jax_report.run(["-R", "ADNI", "-P", "SE-MoE", "--out",
                    str(tmp_path / "jax.md")], project_root=project)
    jax_out = capsys.readouterr().out
    assert port_out.replace("port.md", "x") == jax_out.replace("jax.md", "x")
    assert (tmp_path / "port.md").read_bytes() == (
        tmp_path / "jax.md").read_bytes()


def test_report_of_an_empty_project(tmp_path):
    """No artifacts: the title alone, in both packages."""
    assert (report.generate_report(tmp_path, "ADNI", "UCA-gPoE")
            == jax_report.generate_report(tmp_path, "ADNI", "UCA-gPoE"))


def _roi_frame(path, seed=0, hc=2):
    rng = np.random.default_rng(seed)
    n, d = 40, 6
    cols = [f"ROI_{i}" for i in range(d)]
    frame = pd.DataFrame(rng.random((n, d)) * 0.1, columns=cols)
    frame.insert(0, "participant_id", [f"s{i}" for i in range(n)])
    frame.insert(1, "DIA", [hc] * 20 + [0] * 20)
    frame.insert(2, "AGE", 70)
    frame.insert(3, "PTGENDER", 1)
    frame.loc[frame["DIA"] == 0, "ROI_3"] += 1.0
    frame.loc[frame["DIA"] == hc, "ROI_1"] += 0.5
    frame.to_csv(path, index=False)
    return path


@pytest.mark.parametrize("top_k", [3, None])
def test_roi_deviation_table_equal(tmp_path, top_k):
    path = _roi_frame(tmp_path / "reconstruction_error_roi_mod.csv")
    got = viz.roi_deviation_table(path, hc_label=2, top_k=top_k)
    pd.testing.assert_frame_equal(
        got, jax_viz.roi_deviation_table(path, hc_label=2, top_k=top_k))
    assert got.iloc[0]["roi"] == "ROI_3"


def test_roi_deviation_table_on_the_chain(project):
    """On the test stage's own ROI files."""
    dev_root = (project / "deviation" / "supervised_cvae" / "ADNI"
                / "SE-MoE" / "path_model")
    files = sorted(dev_root.glob("*/reconstruction_error_roi_*.csv"))
    assert len(files) == 3
    for path in files:
        pd.testing.assert_frame_equal(
            viz.roi_deviation_table(path, hc_label=2, top_k=5),
            jax_viz.roi_deviation_table(path, hc_label=2, top_k=5))


def test_auc_summary_table_equal(tmp_path):
    dirs = []
    for i, values in enumerate(([0.7, 0.8, 0.9, 0.08], [0.6, 0.65, 0.02])):
        d = tmp_path / f"run{i}"
        d.mkdir()
        np.savetxt(d / "cvae_auc_and_std.csv", np.array(values),
                   delimiter=",")
        dirs.append(d)
    dirs.append(tmp_path / "missing")
    got = viz.auc_summary_table(dirs, tmp_path / "port.csv")
    pd.testing.assert_frame_equal(
        got, jax_viz.auc_summary_table(dirs, tmp_path / "jax.csv"))
    assert (tmp_path / "port.csv").read_bytes() == (
        tmp_path / "jax.csv").read_bytes()
    np.testing.assert_allclose(got.iloc[0]["mean_auc"], 0.8)
    assert viz.auc_summary_table([]).empty


def test_vendored_geometry_equal():
    assert viz.aal90_centroids() == jax_viz.aal90_centroids()
    assert viz.brain_outlines() == jax_viz.brain_outlines()
    assert len(viz.aal90_centroids()) == 90
