"""``--emit_latent`` in the port's test stage against the JAX CLI's, and the
port's copy of the latent deviation math against its original.

The JAX train CLI trains a tiny SE-PoE cohort; the JAX test stage and the
port's (``--device cpu``) then score copies of it with ``--emit_latent``.
``latent_deviation.csv`` holds no sampled quantity (fused mean and variance
only), so no noise needs replaying: the same columns and rows, numbers within
rtol 1e-5 (atol 1e-6 for the per-dimension z-scores, which pass through
zero).
"""
import argparse
import shutil
import sys
import warnings

import numpy as np
import pandas as pd
import pytest

from multi_modal_normative_modeling_tpu.cli import (
    test_supervised as jax_test,
    train_supervised as jax_train,
)
from multi_modal_normative_modeling_tpu.data.synthetic import (
    make_synthetic_resource,
)
from multi_modal_normative_modeling_tpu.infer import deviation as jax_deviation
from multi_modal_normative_modeling_tpu_torch.cli import (
    test_supervised as port_test,
    train_supervised as port_train,
)
from multi_modal_normative_modeling_tpu_torch.infer import deviation
from tests.test_torch_threads import one_torch_thread  # noqa: F401

MODEL_DIR = "outputs/kfold_analysis/supervised_cvae"
LATENT = 6


def _args(model, **extra):
    return argparse.Namespace(
        dataset_resourse="ADNI", hz_para_list=[16, 16, LATENT],
        procedure="SE-PoE", combine="PoE", epochs=3, n_splits=2,
        oversample_percentage=1, model=model, single_modality=None,
        base_learning_rate=0.0001, max_learning_rate=0.005,
        training_class="nm", lr_schedule="constant", fold_parallel=False,
        precision="fp32", **extra)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("latent_data")
    make_synthetic_resource(root, "ADNI", n_hc=50, n_disease={0: 25},
                            effect=1.0)
    return root


@pytest.fixture(scope="module")
def scored(cohort, tmp_path_factory):
    """model -> (JAX-scored root, port-scored root), both with
    --emit_latent on the JAX train CLI's checkpoints."""
    done = {}

    def run(model):
        if model not in done:
            jax_root = tmp_path_factory.mktemp(f"jax_{model}") / "project"
            shutil.copytree(cohort / "data", jax_root / "data")
            jax_train.main(_args(model), project_root=jax_root)
            port_root = tmp_path_factory.mktemp(f"port_{model}") / "project"
            shutil.copytree(jax_root, port_root)
            jax_test.main(_args(model, emit_latent=True),
                          project_root=jax_root)
            port_test.main(_args(model, emit_latent=True, device="cpu"),
                           project_root=port_root)
            done[model] = (jax_root, port_root)
        return done[model]

    return run


@pytest.mark.parametrize("model", ["cVAE_multimodal", "mvtCAE"])
def test_latent_deviation_csv_matches_jax(scored, model):
    jax_root, port_root = scored(model)
    for fold in range(2):
        rel = f"{MODEL_DIR}/{fold:03d}/latent_deviation.csv"
        ref = pd.read_csv(jax_root / rel)
        got = pd.read_csv(port_root / rel)
        assert list(got.columns) == list(ref.columns) == [
            "participant_id", "DIA", "AGE", "PTGENDER", "Latent deviation"
        ] + [f"latent {i}" for i in range(LATENT)]
        assert len(got) == len(ref) > 0
        pd.testing.assert_frame_equal(got.iloc[:, :4], ref.iloc[:, :4])
        np.testing.assert_allclose(got["Latent deviation"],
                                   ref["Latent deviation"], rtol=1e-5)
        assert (got["Latent deviation"] > 0).all()
        np.testing.assert_allclose(got.iloc[:, 5:].to_numpy(),
                                   ref.iloc[:, 5:].to_numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_models_without_latent_stats_write_no_latent_file(cohort, tmp_path):
    """The DMVAE family has no ``latent_stats``: the flag is taken and the
    stage writes its deviation CSVs only, as the JAX CLI does."""
    root = tmp_path / "project"
    shutil.copytree(cohort / "data", root / "data")
    args = _args("DMVAE", emit_latent=True, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        port_train.main(args, project_root=root)
        port_test.main(args, project_root=root)
    assert list((root / "deviation").rglob("*.csv"))
    assert not list(root.rglob("latent_deviation.csv"))


def test_the_flag_is_off_by_default(scored):
    _, port_root = scored("cVAE_multimodal")
    root = port_root.parent / "no_flag"
    shutil.copytree(port_root, root)
    for stale in root.rglob("latent_deviation.csv"):
        stale.unlink()
    port_test.main(_args("cVAE_multimodal", device="cpu"), project_root=root)
    assert not list(root.rglob("latent_deviation.csv"))
    assert not port_test.build_parser().parse_args([]).emit_latent
    assert port_test.build_parser().parse_args(["--emit_latent"]).emit_latent


# ---- the copied functions against their originals ------------------------------

def _latents(seed, rows=40, dims=5):
    rng = np.random.default_rng(seed)
    mu_train = rng.standard_normal((rows, dims)).astype(np.float32)
    mu_test = rng.standard_normal((rows // 2, dims)).astype(np.float32)
    var_test = np.exp(rng.standard_normal((rows // 2, dims))).astype(
        np.float32)
    return mu_train, mu_test, var_test


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["latent_deviation",
                                  "separate_latent_deviation"])
def test_latent_deviation_functions_bit_equal(name, seed):
    args = _latents(seed)
    got = getattr(deviation, name)(*args)
    want = getattr(jax_deviation, name)(*args)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("rank_deficient", [False, True])
def test_ols_pvalues_equal(rank_deficient):
    rng = np.random.default_rng(3)
    x = np.column_stack([np.ones(30), rng.standard_normal(30)])
    if rank_deficient:
        x[:, 1] = 2.0           # a collapsed latent dim: a constant column
    y = 0.5 * x[:, 1] + rng.standard_normal(30)
    got = deviation._ols_pvalues(y, x)
    want = jax_deviation._ols_pvalues(y, x)
    assert np.array_equal(got, want, equal_nan=True)
    # no residual degree of freedom left: nan, as the original
    rows = 1 if rank_deficient else 2
    assert np.array_equal(deviation._ols_pvalues(y[:rows], x[:rows]),
                          np.full(2, np.nan), equal_nan=True)


def test_logit_pvalues_equal_and_refuse_non_binary_targets():
    rng = np.random.default_rng(4)
    x = np.column_stack([np.ones(60), rng.standard_normal(60)])
    y = (x[:, 1] + 0.5 * rng.standard_normal(60) > 0).astype(float)
    assert np.array_equal(deviation._logit_pvalues(y, x),
                          jax_deviation._logit_pvalues(y, x))
    for module in (deviation, jax_deviation):
        with pytest.raises(ValueError, match="binary 0/1"):
            module._logit_pvalues(y + 1.0, x)


@pytest.mark.parametrize("native", [False, True],
                         ids=["statsmodels if present", "scipy"])
@pytest.mark.parametrize("kind", ["continuous", "binary"])
def test_latent_pvalues_frames_equal(kind, native, monkeypatch):
    """OLS for a continuous target, Logit otherwise; through statsmodels
    where it is installed, and through the scipy implementation that stands
    in for it where it is not (forced here by hiding statsmodels)."""
    if native:
        monkeypatch.setitem(sys.modules, "statsmodels", None)
        monkeypatch.setitem(sys.modules, "statsmodels.api", None)
    rng = np.random.default_rng(5)
    latent = rng.standard_normal((50, 4))
    target = (latent[:, 1] + rng.standard_normal(50)
              if kind == "continuous"
              else (latent[:, 2] + rng.standard_normal(50) > 0).astype(float))
    got = deviation.latent_pvalues(latent, target, kind)
    want = jax_deviation.latent_pvalues(latent, target, kind)
    pd.testing.assert_frame_equal(got, want)
    assert list(got.columns) == ["labels"] + [f"latent {i}" for i in range(4)]
    assert got["labels"].tolist() == ["const", "latent"]
    signal = got.iloc[1, 2 if kind == "continuous" else 3]
    assert signal < 0.05
