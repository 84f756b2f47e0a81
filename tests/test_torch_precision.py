"""``--remat`` and bf16 on the per-modality trainer (train/trainer.py's
default loss), on the CPU.

``remat`` recomputes the loss's forward inside the backward: bit-equal to
the run without it (logs and parameters equal), and held to the JAX
package's ``remat=True`` MultiFoldTrainer on replayed noise at the
trajectory bounds of tests/test_torch_train.py (logs rtol 1e-4, parameters
rtol 5e-3 / atol 1e-5). bf16 runs the forward at the JAX package's cast
points: against JAX's bf16 FoldTrainer on JAX's bf16 noise (drawn in
bfloat16 and widened exactly) every logged term within rtol 2e-2, as
tests/test_torch_packed.py:318-340 holds the packed bf16 path; the master
parameters stay fp32. The sweep CLI trains its grid in bf16 without
``--packed_xla`` (a point's checkpoints byte-equal to the train CLI's run
of it), and a resume across precision or remat is refused.
"""
import argparse
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_normative_modeling_tpu.data.synthetic import (
    make_synthetic_resource,
)
from multi_modal_normative_modeling_tpu.models import build_model as jax_build
from multi_modal_normative_modeling_tpu.parallel import (
    MultiFoldTrainer as JaxMultiFoldTrainer,
    stack_fold_batches as jax_stack_fold_batches,
    stack_params as jax_stack_params,
)
from multi_modal_normative_modeling_tpu.train import (
    FoldTrainer as JaxFoldTrainer,
    TrainConfig as JaxConfig,
)
from multi_modal_normative_modeling_tpu_torch.cli import (
    sweep_supervised,
    train_supervised,
)
from multi_modal_normative_modeling_tpu_torch.interop import (
    params_from_jax,
    params_to_jax,
)
from multi_modal_normative_modeling_tpu_torch.models import build_model
from multi_modal_normative_modeling_tpu_torch.parallel import (
    MultiFoldTrainer,
    stack_fold_batches,
)
from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
from tests.test_torch_packed import bf16_draws
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_train import jax_eps_replay

DIMS = [24, 40, 16]
HIDDEN = [12, 12]
Z, C = 6, 5
SIZES = (37, 21)
EPOCHS, BATCH = 4, 16
LOG_TOL = dict(rtol=1e-4)
PARAM_TOL = dict(rtol=5e-3, atol=1e-5)
BF16_TOL = dict(rtol=2e-2)
MODEL_DIR = "outputs/kfold_analysis/supervised_cvae"


def _tree(name="cVAE_multimodal"):
    jmodel = jax_build(name, DIMS, HIDDEN, Z, C, len(DIMS))
    return jmodel, jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(0)))


def _port(tree, name="cVAE_multimodal", folds=2):
    model = build_model(name, DIMS, HIDDEN, Z, C, len(DIMS), folds=folds)
    return params_from_jax(jax_stack_params([tree] * folds), model)


def _cohorts(seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for n in SIZES:
        data = [rng.standard_normal((n, d)).astype(np.float32) for d in DIMS]
        out.append((data, [rng.standard_normal((n, C)).astype(np.float32)]
                    * len(DIMS)))
    return out


def _batches(cohorts):
    return stack_fold_batches([c[0] for c in cohorts],
                              [c[1] for c in cohorts], BATCH)


def _close_trees(got, ref, **tol):
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


@pytest.mark.parametrize("name", ["cVAE_multimodal", "mvtCAE"])
def test_remat_is_bit_equal_to_no_remat(name):
    _, tree = _tree(name)
    batches = _batches(_cohorts())
    runs = []
    for remat in (False, True):
        model = _port(tree, name)
        config = TrainConfig(epochs=EPOCHS, batch_size=BATCH, combine="poe",
                             remat=remat)
        runs.append((model, MultiFoldTrainer(model, config, 37).run(batches)))
    (a, logs_a), (b, logs_b) = runs
    for k in logs_a:
        np.testing.assert_array_equal(logs_a[k], logs_b[k], err_msg=k)
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k


def test_remat_matches_jax_remat():
    jmodel, tree = _tree()
    cohorts = _cohorts()
    jconfig = JaxConfig(epochs=EPOCHS, batch_size=BATCH, combine="gpoe",
                        remat=True)
    jbatches = jax_stack_fold_batches([c[0] for c in cohorts],
                                      [c[1] for c in cohorts], BATCH)
    key = jax.random.PRNGKey(42)
    ref_params, ref_logs = JaxMultiFoldTrainer(jmodel, jconfig, 37).run(
        jax_stack_params([tree, tree]), jax.device_put(jbatches),
        jnp.stack([key, key]))
    model = _port(tree)
    batches = _batches(cohorts)
    trainer = MultiFoldTrainer(model, TrainConfig(
        epochs=EPOCHS, batch_size=BATCH, combine="gpoe", remat=True), 37)
    assert trainer.loss_meta["remat"] == "True"
    logs = trainer.run(batches, eps=jax_eps_replay(batches["valid"], EPOCHS,
                                                   BATCH, Z))
    for k in ("total", "kl", "ll"):
        np.testing.assert_allclose(logs[k], np.asarray(ref_logs[k]),
                                   **LOG_TOL)
    _close_trees(params_to_jax(model), ref_params, **PARAM_TOL)


@pytest.mark.parametrize("combine", ["gpoe", "moe"])
def test_bf16_matches_jax_bf16(combine):
    """The bf16 forward with fp32 master weights against JAX's bf16
    FoldTrainer (one fold at a time, as the JAX CLI trains it) on JAX's
    bf16 noise: every logged term within rtol 2e-2, and within rtol 2e-2
    of the port's fp32 run."""
    jmodel, tree = _tree()
    cohorts = _cohorts(seed=4)
    jconfig = JaxConfig(epochs=EPOCHS, batch_size=BATCH, combine=combine,
                        precision="bf16")
    ref = []
    for data, cov in cohorts:
        _, logs = JaxFoldTrainer(jmodel, jconfig, 37).run(
            tree, data, cov, key=jax.random.PRNGKey(42))
        ref.append(jax.tree_util.tree_map(np.asarray, logs))
    batches = _batches(cohorts)
    draws = bf16_draws(batches["valid"], EPOCHS, BATCH, Z)
    runs = {}
    for precision in ("bf16", "fp32"):
        model = _port(tree)
        runs[precision] = (model, MultiFoldTrainer(model, TrainConfig(
            epochs=EPOCHS, batch_size=BATCH, combine=combine,
            precision=precision), 37).run(batches, **draws))
    model, logs = runs["bf16"]
    for f in range(len(SIZES)):
        for k in ("total", "kl", "ll"):
            np.testing.assert_allclose(logs[k][f], ref[f][k], err_msg=k,
                                       **BF16_TOL)
            np.testing.assert_allclose(logs[k][f], runs["fp32"][1][k][f],
                                       err_msg=k, **BF16_TOL)
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("name", ["mmJSD", "mvtCAE", "DMVAE",
                                  "WeightedDMVAE", "mmVAEPlus"])
def test_bf16_trains_every_registry_model(name):
    """Every -Model the JAX CLI trains in bf16 trains here: finite logs
    within rtol 2e-2 of the fp32 run over two epochs."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the empty shared code
        _, tree = _tree(name)
        batches = _batches(_cohorts(seed=5))
        logs = {}
        for precision in ("bf16", "fp32"):
            model = _port(tree, name)
            logs[precision] = MultiFoldTrainer(model, TrainConfig(
                epochs=2, batch_size=BATCH, combine="poe",
                precision=precision), 37).run(batches)
    for k in logs["fp32"]:
        assert np.isfinite(logs["bf16"][k]).all(), k
        np.testing.assert_allclose(logs["bf16"][k], logs["fp32"][k],
                                   err_msg=k, rtol=2e-2, atol=1e-3)


@pytest.mark.parametrize("stored,resumed", [
    ({"precision": "fp32"}, {"precision": "bf16"}),
    ({"remat": False}, {"remat": True}),
], ids=["precision", "remat"])
def test_resume_across_precision_or_remat_is_refused(stored, resumed,
                                                     tmp_path):
    _, tree = _tree()
    batches = _batches(_cohorts())

    def trainer(epochs, **config):
        return MultiFoldTrainer(_port(tree), TrainConfig(
            epochs=epochs, batch_size=BATCH, **config), 37)

    trainer(2, **stored).run_resumable(batches, tmp_path, 2, resume=False)
    with pytest.raises(ValueError, match="refusing to resume"):
        trainer(4, **resumed).run_resumable(batches, tmp_path, 2,
                                            resume=True)


# ---- the sweep CLI --------------------------------------------------------

SWEEP = ["-R", "ADHD", "-K", "2", "--procedures", "SE-gPoE", "--hz_grid",
         "16 16 4", "--epochs_list", "2", "--lr_grid", "1e-4:5e-3",
         "--precision", "bf16", "--device", "cpu"]


def test_sweep_trains_bf16_without_packed_xla(tmp_path):
    """A bf16 grid on the per-modality layout: its point's checkpoints
    byte-equal to the train CLI's bf16 run of that point, which differ
    from the fp32 run's."""
    make_synthetic_resource(tmp_path / "sweep", "ADHD", n_hc=30,
                            n_disease={0: 12, 2: 12})
    for name in ("alone", "fp32"):
        shutil.copytree(tmp_path / "sweep" / "data", tmp_path / name / "data")
    records = sweep_supervised.run(SWEEP, project_root=tmp_path / "sweep")
    assert len(records) == 1 and np.isfinite(records[0]["stats"]["auc"]).all()
    args = sweep_supervised._point_args(
        sweep_supervised.build_parser().parse_args(SWEEP), "SE-gPoE",
        [16, 16, 4], 2, 1e-4, 5e-3)
    assert args.precision == "bf16"
    args.batch_size, args.fold_parallel = 256, False
    train_supervised.main(args, project_root=tmp_path / "alone")
    train_supervised.main(argparse.Namespace(**{**vars(args),
                                                "precision": "fp32"}),
                          project_root=tmp_path / "fp32")
    for f in range(2):
        rel = f"{MODEL_DIR}/{f:03d}/cVAE_model.ckpt"
        got = (tmp_path / "sweep" / rel).read_bytes()
        assert got == (tmp_path / "alone" / rel).read_bytes()
        assert got != (tmp_path / "fp32" / rel).read_bytes()
