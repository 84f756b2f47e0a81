"""The port's fused-train-step trainer and CLI against the JAX package's, on
the CPU.

The port's FusedFoldTrainer trains every fold at once on the plain
versions of the fused step; JAX FusedFoldTrainer runs its Pallas kernel in
interpret mode, one fold at a time, from the same init, and the port
replays its noise stream (``jax_eps_replay``). Bounds are
tests/test_fused_cli.py:57-62's: logs rtol 2e-4, parameters rtol 5e-3 /
atol 5e-5. The port's CLI with --fused_train_step writes the files of the
JAX CLI with --fused_train_step, and exits where the JAX CLI falls back to
its XLA path.
"""
import argparse
import shutil

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from multi_modal_normative_modeling_tpu.cli import (
    test_supervised as jax_test,
    train_supervised as jax_train,
)
from multi_modal_normative_modeling_tpu.data.synthetic import (
    make_synthetic_resource,
)
from multi_modal_normative_modeling_tpu.models import build_model as jax_build
from multi_modal_normative_modeling_tpu.train import TrainConfig as JaxConfig
from multi_modal_normative_modeling_tpu.train.fused import (
    FusedFoldTrainer as JaxFusedFoldTrainer,
)
from multi_modal_normative_modeling_tpu_torch.cli import (
    train_supervised as port_train,
)
from multi_modal_normative_modeling_tpu_torch.interop import (
    packed_from_model,
    packed_to_jax,
    params_from_jax,
    read_flax_checkpoint,
)
from multi_modal_normative_modeling_tpu_torch.models import build_model
from multi_modal_normative_modeling_tpu_torch.parallel import stack_params
from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
from multi_modal_normative_modeling_tpu_torch.train.fused import (
    FusedFoldTrainer,
    select_kernel,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_train import jax_eps_replay
from tests.test_torch_train_cli import MODEL_DIR, _jax_init

C = 3


def _cohort(rng, n, dims):
    return ([rng.standard_normal((n, d)).astype(np.float32) for d in dims],
            rng.standard_normal((n, C)).astype(np.float32))


@pytest.mark.parametrize("hidden,latent,combine,epochs", [
    ([10, 8], 4, "gpoe", 6), ([12, 10, 8], 4, "moe", 4)],
    ids=["gpoe", "moe-3hidden"])
def test_fused_trainer_trajectory_matches_jax(hidden, latent, combine,
                                              epochs):
    """Two folds of 19 and 13 subjects, batch 8 (the small fold trains on
    an all-padding batch every epoch), against JAX FusedFoldTrainer per
    fold."""
    dims = [20, 12]
    jmodel = jax_build("cVAE_multimodal", dims, hidden, latent, C, len(dims))
    tree = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    cohorts = [_cohort(rng, 19, dims), _cohort(rng, 13, dims)]
    jconfig = JaxConfig(epochs=epochs, batch_size=8, combine=combine)
    key = jax.random.PRNGKey(42)
    ref = [JaxFusedFoldTrainer(jmodel, jconfig, 19, interpret=True).run(
        tree, data, cov, key=key) for data, cov in cohorts]

    model = build_model("cVAE_multimodal", dims, hidden, latent, C,
                        len(dims), folds=2)
    params_from_jax(stack_params([tree, tree]), model)
    trainer = FusedFoldTrainer(
        model, TrainConfig(epochs=epochs, batch_size=8, combine=combine), 19)
    batches = trainer.batches([d for d, _ in cohorts], [c for _, c in cohorts],
                              "cpu")
    assert not batches.valid_host[-1, 1]
    eps = jax_eps_replay(batches.valid_host.T, epochs, 8, latent)
    trained, logs = trainer.run(packed_from_model(model, trainer.stacked),
                                batches, eps=eps)
    for f, (ref_params, ref_logs) in enumerate(ref):
        for k in ("total", "kl", "ll"):
            np.testing.assert_allclose(logs[k][f], np.asarray(ref_logs[k]),
                                       rtol=2e-4)
        got = packed_to_jax(trained, trainer.stacked, fold=f)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(ref_params)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=5e-3,
                                       atol=5e-5)
    # padded entries (modality 1 is narrower than d_max) stay exactly zero
    assert torch.count_nonzero(
        trained["enc"]["layers"][0]["w"][:, 1, 12:20]) == 0
    assert torch.count_nonzero(trained["dec"]["lvo"][:, 1, 12:]) == 0


def _ragged_run(precision, through_autograd, epochs=3, tile_b=None):
    """Two folds (19 and 13 subjects, batch 8) at widths that are not
    multiples of 4 anywhere, trained from one seeded init and noise."""
    dims, hidden, latent = [21, 10], [13, 9], 5
    model = build_model("cVAE_multimodal", dims, hidden, latent, C, len(dims),
                        folds=2, generator=torch.Generator().manual_seed(0))
    config = TrainConfig(epochs=epochs, batch_size=8, combine="gpoe",
                         precision=precision)
    trainer = FusedFoldTrainer(model, config, 19, tile_b=tile_b)
    rng = np.random.default_rng(1)
    cohorts = [_cohort(rng, 19, dims), _cohort(rng, 13, dims)]
    batches = trainer.batches([d for d, _ in cohorts], [c for _, c in cohorts],
                              "cpu")
    eps = rng.standard_normal(
        (epochs * batches.n_batches, 2, 8, latent)).astype(np.float32)
    trained, logs = trainer.run(packed_from_model(model, trainer.stacked),
                                batches, eps=eps,
                                through_autograd=through_autograd)
    return trainer, trained, logs


@pytest.mark.parametrize("precision,tile_b", [("fp32", None), ("bf16", 8)])
def test_flat_gradient_path_equals_step_function_path(precision, tile_b):
    """The trainer hands the step's flat gradient buffer to MaskedAdam; the
    long way (StepFunction under autograd, gradients scaled by the incoming
    one and concatenated again) follows the same trajectory bit for bit."""
    _, flat, flat_logs = _ragged_run(precision, False, tile_b=tile_b)
    _, auto, auto_logs = _ragged_run(precision, True, tile_b=tile_b)
    for k in flat_logs:
        assert np.array_equal(flat_logs[k], auto_logs[k]), k
    a, b = (jax.tree_util.tree_leaves(t) for t in (flat, auto))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_padded_columns_stay_zero_after_three_steps():
    """Training runs in the padded layout: after 3 steps every padded entry
    of every parameter is still exactly zero, and unpad_named hands back
    the true shapes."""
    trainer, trained, logs = _ragged_run("fp32", False, epochs=1)
    step = trainer.step
    assert step.Dp == 24 and step.Cp == 4 and step.Zp == 8
    named = step.pad_params(trained)
    ones = step.widen({k: torch.ones_like(v)
                       for k, v in step.strip(named).items()})
    for k, t in named.items():
        assert torch.count_nonzero(t[ones[k] == 0]) == 0, k
    assert trained["enc"]["layers"][0]["w"].shape == (2, 2, 21 + C, 13)
    assert trained["dec"]["wm"].shape == (2, 2, 13, 21)
    assert all(np.isfinite(v).all() for v in logs.values())


def test_bf16_fused_trainer_runs_k6(tmp_path):
    dims = [20, 12]
    model = build_model("cVAE_multimodal", dims, [10, 8], 4, C, len(dims),
                        folds=2, generator=torch.Generator().manual_seed(0))
    config = TrainConfig(epochs=3, batch_size=8, combine="gpoe",
                         precision="bf16")
    trainer = FusedFoldTrainer(model, config, 19, tile_b=16)
    assert trainer.kernel == "tiled" and trainer.step.tile_b == 16
    rng = np.random.default_rng(1)
    cohorts = [_cohort(rng, 19, dims), _cohort(rng, 13, dims)]
    batches = trainer.batches([d for d, _ in cohorts], [c for _, c in cohorts],
                              "cpu")
    assert batches.x.dtype == torch.bfloat16 and batches.rows == 16
    trained, logs = trainer.run(packed_from_model(model, trainer.stacked),
                                batches)
    assert all(np.isfinite(v).all() and v.shape == (2, 3)
               for v in logs.values())
    # resumable (ported): in chunks of 2 epochs, one train state, the same
    # run bit for bit
    trained_r, logs_r = trainer.run_resumable(
        packed_from_model(model, trainer.stacked), batches, tmp_path, 2)
    assert (tmp_path / "train_state.ckpt").exists()
    for k in logs:
        assert np.array_equal(logs_r[k], logs[k]), k
    for a, b in zip(jax.tree_util.tree_leaves(trained_r),
                    jax.tree_util.tree_leaves(trained)):
        assert torch.equal(a, b)


def test_fused_trainer_at_adhd_h460_matches_the_benchmark_reference():
    """FusedFoldTrainer (its plain version on the CPU) at the ADHD grid's
    widest point, -H 460 460 40 over [116, 116] with c 29, against the
    benchmark's plain reference (perfbench/reference/cvae.py, written from
    the model's equations), on seeded random weights: 2 folds of 40 rows,
    batch 16 (a last batch of 8), 2 epochs, 6 Adam steps, compared by the
    benchmark's own numbers (perfbench/compare.py). Both are fp32, the same
    equations summed in another order: on three seeds they read loss_gap
    1.2e-07 to 2.1e-07, ll_gap 0 to 1.1e-07, change_gap 9.9e-06 to
    1.3e-05, and the reference in TF32 in the program's place 2.5e-05 to
    7.7e-05, 8.2e-07 to 2.1e-06 and 4.0e-03 to 9.3e-03. The limits sit
    ten to a hundred times above the first and fail the second twice."""
    from perfbench import compare, inputs
    from perfbench.reference.cvae import Reference

    cfg = {"input_dim_list": [116, 116], "hidden_dim": [460, 460],
           "latent_dim": 40, "c_dim": 29, "combine": "gpoe"}
    folds, n, batch, epochs, lr = 2, 40, 16, 2, 1e-4
    gen = inputs.generator(2**31 + 23, "train_job", 0, "cpu")
    tree = inputs.init_tree(cfg, folds, gen)
    rows = inputs.normal(gen, (folds, n, 232))
    cov = inputs.one_hot_covariates(gen, (folds, n), 29)
    eps = inputs.normal(gen, (epochs * 3, folds, batch, 40))
    xs = [rows[..., :116], rows[..., 116:]]
    model = build_model("cVAE_multimodal", [116, 116], [460, 460], 40, 29,
                        2, folds=folds)
    trainer = FusedFoldTrainer(model, TrainConfig(
        epochs=epochs, batch_size=batch, learning_rate=lr, combine="gpoe"),
        n)
    assert trainer.kernel == "single"
    batches = trainer.batches(
        [[x[f].numpy() for x in xs] for f in range(folds)],
        [cov[f].numpy() for f in range(folds)], "cpu")
    assert batches.n_batches == 3
    trained, logs = trainer.run(trainer.stacked.pack_params(tree), batches,
                                eps=eps)
    ref_tree, ref_logs, first_grad = Reference(cfg).train_job(
        tree, xs, cov, eps, epochs, batch, lr)
    found = compare.train_loss_numbers(logs, ref_logs, epochs)
    assert found["loss_gap"] <= 2e-6 and found["ll_gap"] <= 5e-6, found
    gap = compare.change_gap(tree, compare.packed_to_tree(trained, cfg),
                             ref_tree, first_grad)
    assert gap <= 1e-3, gap


def test_select_kernel_reasons():
    model = build_model("cVAE_multimodal", [20, 12], [10, 8], 4, C, 2)
    assert select_kernel(model, TrainConfig(combine="gpoe")) == ("single", "")
    assert select_kernel(model, TrainConfig(combine="gpoe",
                                            precision="bf16"))[0] == "tiled"
    for config, reason in ((TrainConfig(combine="gpoe", shuffle=True),
                            "shuffle"),
                           (TrainConfig(combine="sum"), "fusion"),
                           (TrainConfig(combine="gpoe", precision="fp16"),
                            "precision")):
        kernel, why = select_kernel(model, config)
        assert kernel is None and reason in why
    # 480 wide takes K5's wide-hidden route in fp32; 700 fits no route
    wide = build_model("cVAE_multimodal", [20, 12], [480], 4, C, 2)
    assert select_kernel(wide, TrainConfig(combine="gpoe")) == ("single", "")
    kernel, why = select_kernel(wide, TrainConfig(combine="gpoe",
                                                  precision="bf16"))
    assert kernel is None and "shared memory" in why
    wider = build_model("cVAE_multimodal", [20, 12], [700], 4, C, 2)
    kernel, why = select_kernel(wider, TrainConfig(combine="gpoe"))
    assert kernel is None and "shared memory" in why


# ---- the CLI ----------------------------------------------------------------

def _args(**extra):
    base = dict(
        dataset_resourse="ADNI", hz_para_list=[16, 16, 4],
        procedure="SE-MoE", combine="MoE", epochs=3, n_splits=2,
        oversample_percentage=1, model="cVAE_multimodal",
        single_modality=None, base_learning_rate=0.0001,
        max_learning_rate=0.005, training_class="nm",
        lr_schedule="constant", precision="fp32", batch_size=5,
        fused_train_step=True)
    base.update(extra)
    return argparse.Namespace(**base)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("fused_cli")
    make_synthetic_resource(base / "jax", "ADNI", n_hc=30,
                            n_disease={0: 11, 1: 10})
    # the JAX CLI runs the fused step only without --fold_parallel
    jax_train.main(_args(fold_parallel=False), project_root=base / "jax")
    shutil.copytree(base / "jax" / "data", base / "port" / "data")
    port_train.main(_args(fold_parallel=True, device="cpu"),
                    project_root=base / "port", init_fn=_jax_init,
                    eps_fn=jax_eps_replay)
    return {"jax": base / "jax", "port": base / "port"}


def test_fused_cli_matches_jax(roots, capsys):
    for f in range(2):
        for kind in ("train", "test"):
            rel = f"outputs/kfold_analysis/{kind}_ids_{f:03d}.csv"
            assert ((roots["port"] / rel).read_bytes()
                    == (roots["jax"] / rel).read_bytes())
        ref, ref_config = read_flax_checkpoint(roots["jax"] / MODEL_DIR
                                               / f"{f:03d}")
        got, config = read_flax_checkpoint(roots["port"] / MODEL_DIR
                                           / f"{f:03d}")
        assert config == ref_config
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(ref)):
            np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-5)


def test_jax_test_stage_scores_fused_checkpoints(roots, tmp_path):
    shutil.copytree(roots["port"], tmp_path / "scored")
    jax_test.main(_args(fused_train_step=False), project_root=tmp_path
                  / "scored")
    dev = (tmp_path / "scored" / "deviation" / "supervised_cvae" / "ADNI"
           / "SE-MoE" / "path_model" / "av45"
           / "reconstruction_error_av45.csv")
    values = pd.read_csv(dev).select_dtypes("number").to_numpy()
    assert values.size and np.isfinite(values).all()


def test_fused_cli_bf16_writes_checkpoints(roots, tmp_path):
    shutil.copytree(roots["jax"] / "data", tmp_path / "data")
    port_train.main(_args(device="cpu", precision="bf16", epochs=2),
                    project_root=tmp_path)
    for f in range(2):
        params, _ = read_flax_checkpoint(tmp_path / MODEL_DIR / f"{f:03d}")
        assert all(np.isfinite(a).all()
                   for a in jax.tree_util.tree_leaves(params))


@pytest.mark.parametrize("extra,match", [
    ({"model": "mmJSD"}, "cVAE_multimodal"),
    ({"combine": "Sum"}, "fusion 'Sum'"),
    ({"fused_decoder": True}, "mutually exclusive"),
    ({"fused_train_step": False, "precision": "bf16"}, None),
], ids=["variant", "fusion", "fused_decoder", "bf16_without_fused"])
def test_fused_cli_exits_before_writing(extra, match, tmp_path, roots):
    if match is None:
        # ported: bf16 without the fused train step trains the per-modality
        # layout in bf16 (tests/test_torch_precision.py); fp32 checkpoints
        shutil.copytree(roots["jax"] / "data", tmp_path / "data")
        port_train.main(_args(device="cpu", epochs=1, **extra),
                        project_root=tmp_path)
        for f in range(2):
            params, _ = read_flax_checkpoint(tmp_path / MODEL_DIR
                                             / f"{f:03d}")
            assert all(np.isfinite(a).all() and a.dtype == np.float32
                       for a in jax.tree_util.tree_leaves(params))
        return
    with pytest.raises(SystemExit, match=match):
        port_train.main(_args(device="cpu", **extra), project_root=tmp_path)
    assert not (tmp_path / "outputs").exists()


def test_fused_cli_exits_on_wide_hidden_layers(roots, tmp_path):
    """Past K5's widest route (648 in fp32) the CLI exits with the limit."""
    shutil.copytree(roots["jax"] / "data", tmp_path / "data")
    with pytest.raises(SystemExit, match="shared memory.*up to 648"):
        port_train.main(_args(device="cpu", hz_para_list=[700, 4]),
                        project_root=tmp_path)


def test_fused_cli_exits_on_per_modality_covariates(roots, tmp_path,
                                                    monkeypatch):
    shutil.copytree(roots["jax"] / "data", tmp_path / "data")
    prepare = port_train.common.prepare_folds

    def differing(*args, **kwargs):
        folds, dims, c_dim = prepare(*args, **kwargs)
        return [(data, [cov[0]] + [c + 1.0 for c in cov[1:]])
                for data, cov in folds], dims, c_dim

    monkeypatch.setattr(port_train.common, "prepare_folds", differing)
    with pytest.raises(SystemExit, match="covariates differ"):
        port_train.main(_args(device="cpu"), project_root=tmp_path)
