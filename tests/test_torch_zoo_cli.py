"""Every registry model through the port's train -> test -> analysis chain
on the CPU, on the cohort of tests/test_model_zoo_cli.py, and the two stages
crossed with the JAX package's.

Crossed (mvtCAE; DMVAE with a real shared code, ``-H 24 24 40``): the JAX
train CLI's checkpoints are scored by the JAX test stage and by the port's
(``--device cpu``) with the JAX noise replayed (PRNGKey(1000 + fold) at the
model's ``noise_dim``): normalized_* CSVs byte-equal, the rest within rtol
1e-4 / atol 1e-5, the bounds of tests/test_torch_pipeline.py. The other way
round, the JAX test stage scores checkpoints the port's train stage wrote.
"""
import argparse
import json
import shutil
import warnings

import jax
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
from multi_modal_normative_modeling_tpu_torch.cli import (
    group_analysis,
    pipeline,
    test_supervised as port_test,
    train_supervised as port_train,
)
from multi_modal_normative_modeling_tpu_torch.interop import (
    read_flax_checkpoint,
)
from multi_modal_normative_modeling_tpu_torch.kernels import (
    deviation as dev_kernel,
    mlp as mlp_kernel,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

MODELS = ["cVAE_multimodal", "mmJSD", "DMVAE", "WeightedDMVAE", "mvtCAE",
          "mmVAEPlus"]
MODEL_DIR = "outputs/kfold_analysis/supervised_cvae"
CROSSED = {"mvtCAE": [24, 24, 8], "DMVAE": [24, 24, 40]}


def _args(model, **overrides):
    base = dict(
        dataset_resourse="ADNI", hz_para_list=[24, 24, 8],
        procedure="SE-PoE", combine="PoE", epochs=8, n_splits=2,
        oversample_percentage=1, model=model, single_modality=None,
        base_learning_rate=0.0001, max_learning_rate=0.005,
        training_class="nm", lr_schedule="constant", fold_parallel=False,
        precision="fp32")
    base.update(overrides)
    return argparse.Namespace(**base)


def _jax_eps(fold, padded_rows, z_dim):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(1000 + fold),
                                        (padded_rows, z_dim)))


def _test_outputs(root):
    """Relative paths of the CSVs the test stage writes."""
    out = {p.relative_to(root) for p in (root / "deviation").rglob("*.csv")}
    out |= {p.relative_to(root)
            for p in (root / MODEL_DIR).glob("*/*/*.csv")}
    return out


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo_data")
    make_synthetic_resource(root, "ADNI", n_hc=40, n_disease={0: 20, 1: 20},
                            effect=0.8)
    return root


@pytest.fixture(scope="module")
def port_chains(cohort, tmp_path_factory):
    """model -> (root, analysis stats) of the port's chain, run on demand."""
    done = {}

    def run(model):
        if model not in done:
            root = tmp_path_factory.mktemp(f"port_{model}") / "project"
            shutil.copytree(cohort / "data", root / "data")
            args = _args(model, device="cpu")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                port_train.main(args, project_root=root)
                port_test.main(args, project_root=root)
                stats = group_analysis.main(args, project_root=root)
            done[model] = (root, stats)
        return done[model]

    return run


@pytest.mark.parametrize("model", MODELS)
def test_port_chain_runs_every_model(port_chains, model):
    before = (mlp_kernel.fused_encoder.launches,
              dev_kernel.fused_pred_deviation.launches)
    root, stats = port_chains(model)
    assert len(stats["auc"]) == 3 and np.isfinite(stats["auc"]).all()
    assert all(0.0 <= a <= 1.0 for a in stats["auc"])
    assert len(_test_outputs(root)) == 2 * 3 * 5 + 3 * 5
    for fold in range(2):
        tree, config = read_flax_checkpoint(root / MODEL_DIR / f"{fold:03d}")
        assert config["model"] == model and config["latent_dim"] == 8
        assert ("weights" in tree) == (model == "WeightedDMVAE")
        assert ("alpha" in tree) == (model in ("cVAE_multimodal", "mmJSD",
                                               "mvtCAE"))
    events = [json.loads(line) for line in
              (root / MODEL_DIR / "run_log.jsonl").read_text().splitlines()]
    done = [e for e in events if e["event"] == "fold_done"]
    extra = {"mmJSD": {"jsd"}, "mvtCAE": {"tc"}}.get(model, set())
    assert len(done) == 2
    for event in done:
        assert {"total", "kl", "ll"} | extra <= set(event)
        assert all(np.isfinite(event[k]) for k in {"total", "kl", "ll"}
                   | extra)
    # CPU tensors take the kernels' plain versions and count no launch
    assert before == (mlp_kernel.fused_encoder.launches,
                      dev_kernel.fused_pred_deviation.launches)


@pytest.mark.parametrize("model", ["mmJSD", "WeightedDMVAE"])
def test_pipeline_passes_the_model_through(cohort, port_chains, model,
                                           tmp_path):
    """``cli.pipeline -Model <m>`` in one process writes what the three
    stages write apart."""
    apart, _ = port_chains(model)
    root = tmp_path / "project"
    shutil.copytree(cohort / "data", root / "data")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        pipeline.run(["-R", "ADNI", "-P", "SE-PoE", "-C", "PoE", "-E", "8",
                      "-K", "2", "-H", "24", "24", "8", "-Model", model,
                      "--device", "cpu", "--emit_latent"],
                     project_root=root)
    # only a model with latent_stats writes the latent file
    latent = sorted(p.relative_to(root / MODEL_DIR)
                    for p in root.rglob("latent_deviation.csv"))
    assert [str(p) for p in latent] == (
        ["000/latent_deviation.csv", "001/latent_deviation.csv"]
        if model == "mmJSD" else [])
    files = _test_outputs(apart)
    assert _test_outputs(root) == files
    for rel in sorted(files):
        assert (root / rel).read_bytes() == (apart / rel).read_bytes(), rel
    for fold in range(2):
        rel = f"{MODEL_DIR}/{fold:03d}/cVAE_model.ckpt"
        assert (root / rel).read_bytes() == (apart / rel).read_bytes()


@pytest.mark.parametrize("flag", ["fused_decoder", "fused_train_step"])
@pytest.mark.parametrize("model", MODELS[1:])
def test_fused_paths_exit_for_the_other_models(model, flag, tmp_path):
    """Both fused paths compute cVAE_multimodal's loss; where the JAX CLI
    prints and falls back, the port exits with the reason and writes
    nothing."""
    args = _args(model, device="cpu", **{flag: True})
    with pytest.raises(SystemExit, match=f"{model}.*cVAE_multimodal loss"):
        port_train.main(args, project_root=tmp_path)
    assert not (tmp_path / "outputs").exists()


@pytest.fixture(scope="module")
def crossed(cohort, tmp_path_factory):
    """model -> (JAX-scored root, port-scored root) on the JAX train CLI's
    checkpoints."""
    done = {}

    def run(model):
        if model not in done:
            jax_root = tmp_path_factory.mktemp(f"jax_{model}") / "project"
            shutil.copytree(cohort / "data", jax_root / "data")
            args = _args(model, hz_para_list=CROSSED[model], epochs=4)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                jax_train.main(args, project_root=jax_root)
                port_root = tmp_path_factory.mktemp(f"x_{model}") / "project"
                shutil.copytree(jax_root, port_root)
                jax_test.main(args, project_root=jax_root)
                port_test.main(
                    _args(model, hz_para_list=CROSSED[model], device="cpu"),
                    project_root=port_root, eps_fn=_jax_eps)
            done[model] = (jax_root, port_root)
        return done[model]

    return run


@pytest.mark.parametrize("model", list(CROSSED))
def test_port_test_stage_matches_jax_on_jax_checkpoints(crossed, model):
    jax_root, port_root = crossed(model)
    jax_files = _test_outputs(jax_root)
    assert len(jax_files) == 2 * 3 * 5 + 3 * 5
    assert _test_outputs(port_root) == jax_files
    for rel in sorted(jax_files):
        if rel.name.startswith("normalized_"):
            assert (port_root / rel).read_bytes() == \
                (jax_root / rel).read_bytes(), rel
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
                                   rtol=1e-4, atol=1e-5, err_msg=str(rel))


@pytest.mark.parametrize("model", ["mvtCAE", "DMVAE"])
def test_jax_test_stage_reads_the_ports_checkpoints(port_chains, model,
                                                    tmp_path):
    port_root, _ = port_chains(model)
    root = tmp_path / "project"
    shutil.copytree(port_root / "data", root / "data")
    shutil.copytree(port_root / "outputs", root / "outputs")
    for stale in (root / MODEL_DIR).glob("*/*/*.csv"):
        stale.unlink()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jax_test.main(_args(model), project_root=root)
    files = _test_outputs(root)
    assert files == _test_outputs(port_root)
    for rel in sorted(files):
        values = pd.read_csv(root / rel).select_dtypes("number").to_numpy()
        assert values.size and np.isfinite(values).all(), rel
        if rel.name.startswith("normalized_"):
            assert (root / rel).read_bytes() == \
                (port_root / rel).read_bytes(), rel
