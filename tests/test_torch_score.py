"""The port's batch scorer (cli/score.py) and its fold-ensemble core
(infer/ensemble.py) against the JAX package's, on the CPU.

One UCA-gPoE project (four modalities, gPoE fusion, 2 folds) is trained by
the JAX trainer; both packages then score it from the same checkpoints with
the same eps (the JAX stream PRNGKey(seed + fold), replayed through
``eps_fn``). The port runs the kernels' plain versions here (--device
cpu). Bounds: rtol 1e-4 / atol 1e-5, the test stage's CSV bound (float32
model math in another order)."""
import argparse

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from multi_modal_normative_modeling_tpu.cli import (
    score as jax_score,
    train_supervised,
)
from multi_modal_normative_modeling_tpu.data.synthetic import (
    make_synthetic_resource,
)
from multi_modal_normative_modeling_tpu.infer import ensemble as jax_ensemble
from multi_modal_normative_modeling_tpu_torch.cli import score, serve
from multi_modal_normative_modeling_tpu_torch.infer import ensemble
from tests.test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)


def jax_eps(seed, rows, z_dim):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                        (rows, z_dim)))


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    root = tmp_path_factory.mktemp("score_project")
    make_synthetic_resource(root, "ADNI", n_hc=40, n_disease={0: 16, 1: 16},
                            effect=1.2, with_early_fusion=True)
    train_supervised.main(argparse.Namespace(
        dataset_resourse="ADNI", hz_para_list=[16, 16, 6],
        procedure="UCA-gPoE", combine="gPoE", epochs=5, n_splits=2,
        oversample_percentage=1, model="cVAE_multimodal",
        single_modality=None, base_learning_rate=0.0001,
        max_learning_rate=0.005, training_class="nm",
        lr_schedule="constant", fold_parallel=True, precision="fp32"),
        project_root=root)
    y = pd.read_csv(root / "data" / "ADNI" / "y.csv")
    y[["IID"]].to_csv(root / "all_ids.csv", index=False)
    y[["IID"]].head(1).to_csv(root / "one_id.csv", index=False)
    return root


def _args(root, name, ids="all_ids.csv", **extra):
    values = dict(dataset_resourse="ADNI", procedure="UCA-gPoE",
                  combine=None, n_splits=2, ids=str(root / ids), fold=None,
                  output=str(root / f"{name}.csv"),
                  roi_output=str(root / f"{name}_roi.csv"), seed=42,
                  latent=True, mesh=None)
    values.update(extra)
    return argparse.Namespace(**values)


@pytest.mark.parametrize("fold", [None, 1])
def test_score_csvs_match_jax(project, fold):
    """The deviation and latent columns and the ROI CSV, ensemble and
    --fold, on replayed eps."""
    jax_out = jax_score.score(_args(project, f"jax_{fold}", fold=fold),
                              project_root=project)
    port_out = score.score(_args(project, f"port_{fold}", fold=fold,
                                 device="cpu"),
                           project_root=project, eps_fn=jax_eps)
    assert list(port_out.columns) == ["participant_id", "deviation",
                                      "latent_deviation"]
    assert list(port_out["participant_id"]) == list(jax_out["participant_id"])
    for name in ("deviation", "latent_deviation"):
        np.testing.assert_allclose(port_out[name], jax_out[name], **TOL)
    for suffix in ("", "_roi"):
        port_csv = pd.read_csv(project / f"port_{fold}{suffix}.csv")
        jax_csv = pd.read_csv(project / f"jax_{fold}{suffix}.csv")
        assert list(port_csv.columns) == list(jax_csv.columns)
        assert port_csv.shape == jax_csv.shape
        np.testing.assert_allclose(port_csv.iloc[:, 1:].to_numpy(),
                                   jax_csv.iloc[:, 1:].to_numpy(), **TOL)
    roi = pd.read_csv(project / f"port_{fold}_roi.csv")
    assert roi.shape == (72, 1 + 3 * 90 + 270)
    assert roi.columns[1].endswith("_av45")
    assert roi.columns[-1].endswith("_early_fusion_modalities_ADNI")


def test_score_single_subject_and_cohort_independence(project):
    """Covariates binned by the train cohort: a subject's score does not
    depend on who else is scored, and one subject works."""
    full = score.score(_args(project, "full", fold=0, latent=False,
                             output=None, device="cpu"), project_root=project)
    single = score.score(_args(project, "single", ids="one_id.csv", fold=0,
                               latent=False, output=None, device="cpu"),
                         project_root=project)
    assert len(single) == 1
    target = full[full["participant_id"]
                  == single["participant_id"].iloc[0]]["deviation"].iloc[0]
    np.testing.assert_allclose(single["deviation"].iloc[0], target,
                               rtol=1e-5)


def test_score_matches_the_service(project):
    """The batch scorer's per-fold host scaling against the service's
    on-device scaling, on the port's own noise stream (the same draw per
    fold at the same padded size)."""
    out = score.score(_args(project, "vs_service", device="cpu"),
                      project_root=project)
    service = serve.ScoringService("ADNI", "UCA-gPoE", n_splits=2,
                                   project_root=project, device="cpu")
    served = service.score_ids(list(out["participant_id"]), roi=True,
                               latent=True)
    np.testing.assert_allclose(served["deviation"], out["deviation"],
                               rtol=2e-4)
    np.testing.assert_allclose(served["latent_deviation"],
                               out["latent_deviation"], rtol=1e-4, atol=1e-6)
    roi = pd.read_csv(project / "vs_service_roi.csv")
    assert served["roi_columns"] == list(roi.columns[1:])
    np.testing.assert_allclose(served["roi"], roi.iloc[:, 1:].to_numpy(),
                               rtol=2e-4, atol=1e-5)


def test_ensemble_state_and_latent_statistics_match_jax(project):
    """load_ensemble's scalers and train covariate cohorts, and the
    train-cohort latent moments of each fold (ragged folds padded and
    masked in one fold-stacked call)."""
    state = ensemble.load_ensemble("ADNI", "UCA-gPoE", n_splits=2,
                                   project_root=project, device="cpu")
    want = jax_ensemble.load_ensemble("ADNI", "UCA-gPoE", n_splits=2,
                                      project_root=project)
    assert state.combine == want.combine == "gPoE"
    assert state.dataset_names == want.dataset_names
    assert state.columns == want.columns
    for got, ref in zip(state.centers + state.scales,
                        want.centers + want.scales):
        np.testing.assert_array_equal(got.numpy(), ref)
    for got, ref in zip(state.train_covs, want.train_covs):
        pd.testing.assert_frame_equal(got.reset_index(drop=True),
                                      ref.reset_index(drop=True))
    np.testing.assert_array_equal(state.seeds, want.seeds)
    assert state.latent_mean is None
    ensemble.ensure_latent_stats(state)
    jax_ensemble.ensure_latent_stats(want)
    assert state.latent_mean.shape == (2, 6)
    np.testing.assert_allclose(state.latent_mean.numpy(), want.latent_mean,
                               **TOL)
    np.testing.assert_allclose(state.latent_var.numpy(), want.latent_var,
                               **TOL)


def test_latent_stats_fused_matches_latent_stats(project):
    """The latent path through the encoder kernel's wrapper (its plain
    version on CPU tensors) gives latent_stats' values."""
    state = ensemble.load_ensemble("ADNI", "UCA-gPoE", n_splits=2,
                                   project_root=project, device="cpu")
    rng = np.random.default_rng(3)
    xs = [torch.from_numpy(rng.standard_normal((2, 9, d), dtype=np.float32))
          for d in (90, 90, 90, 270)]
    c = torch.from_numpy(np.eye(29, dtype=np.float32)[
        rng.integers(0, 29, (2, 9))])
    with torch.no_grad():
        want = state.model.latent_stats(xs, [c] * 4, "gPoE")
    got = state.model.latent_stats_fused(xs, [c] * 4, "gPoE")
    for g, w in zip(got, want):
        assert g.shape == (2, 9, 6)
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case,error,match", [
    ("mesh", SystemExit, "queue 1 item 'Multi-device'"),
    ("no card", SystemExit, "no CUDA device"),
    ("no checkpoint", FileNotFoundError, "train first")])
def test_score_refusals(project, monkeypatch, case, error, match):
    extra = {"mesh": {"mesh": "2,1"},
             "no card": {"device": "cuda"},
             "no checkpoint": {"fold": 5, "device": "cpu"}}[case]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(error, match=match):
        score.score(_args(project, "refused", **extra), project_root=project)


def test_load_ensemble_runs_on_the_card_by_default(project, monkeypatch):
    """A library caller who names no device gets the card, or an error
    where there is none; never the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        ensemble.load_ensemble("ADNI", "UCA-gPoE", n_splits=2,
                               project_root=project)


def test_score_cli_flags(project, capsys):
    """run() parses the JAX CLI's flags plus --device and writes the CSVs."""
    out = score.run(["-R", "ADNI", "-P", "UCA-gPoE", "-K", "2", "--ids",
                     str(project / "one_id.csv"), "--output",
                     str(project / "cli.csv"), "--device", "cpu"],
                    project_root=project)
    assert len(out) == 1 and "latent_deviation" not in out
    assert "scored 1 subjects (ensemble of 2 folds)" in capsys.readouterr().out
    assert pd.read_csv(project / "cli.csv").shape == (1, 2)
