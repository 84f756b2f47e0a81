"""Resumable training in the port, on the CPU.

Every trainer advances one ``TrainSession``: a run in chunks, and a run
killed after a chunk and resumed from its train state in a fresh trainer,
must equal the uninterrupted run bit for bit (parameters, Adam's state, the
BatchNorm running statistics, the logs), with the port's own noise
generators and with replayed draws. Cases: the plain loss, the
--fused_decoder loss, the cyclic schedule (it reads each fold's step
count), the regression's per-epoch shuffle with its FI extra, the
end-to-end model's BatchNorm state, labels and dropout keep masks, and the
fused train step in fp32 (K5's plain version) and bf16 (K6's).

Through the CLIs: a run killed after ``-E 2 --checkpoint_every 2`` and
resumed with ``-E 4 --checkpoint_every 2 --resume`` in a fresh ``main``
writes fold checkpoints byte-equal to the straight run's, on the train
CLI's three paths and for nm-PM-cont, nm-MLP and the regression.

Against the JAX package (its MultiFoldTrainer, same init, replayed noise):
the port's milestones and its killed-and-resumed run within the trainer
bounds of tests/test_torch_train.py, logs rtol 1e-4 and parameters rtol
5e-3 / atol 1e-5. Refused: a resume under another loss, precision, batch
size or fused kernel, with the JAX package's message, and a train state
the JAX package wrote.
"""
import argparse
import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_normative_modeling_tpu.data.synthetic import (
    make_synthetic_resource,
)
from multi_modal_normative_modeling_tpu.parallel import (
    MultiFoldTrainer as JaxMultiFoldTrainer,
    stack_fold_batches as jax_stack_fold_batches,
    stack_params as jax_stack_params,
)
from multi_modal_normative_modeling_tpu.train import TrainConfig as JaxConfig
from multi_modal_normative_modeling_tpu.train.checkpoints import (
    save_train_state as jax_save_train_state,
)
from multi_modal_normative_modeling_tpu_torch.cli import (
    nmmlp,
    nmpmcont,
    regression,
    train_supervised,
)
from multi_modal_normative_modeling_tpu_torch.interop import (
    packed_from_model,
    params_to_jax,
)
from multi_modal_normative_modeling_tpu_torch.kernels.decoder_nll import (
    fused_decoder_loss_fn,
)
from multi_modal_normative_modeling_tpu_torch.models import build_model
from multi_modal_normative_modeling_tpu_torch.models.endtoend import (
    EndToEndCVAE,
    endtoend_loss_fn,
)
from multi_modal_normative_modeling_tpu_torch.models.regression import (
    RegressionCVAE,
    regression_loss_fn,
)
from multi_modal_normative_modeling_tpu_torch.parallel import (
    MultiFoldTrainer,
    stack_fold_batches,
)
from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
from multi_modal_normative_modeling_tpu_torch.train.checkpoints import (
    load_train_state,
    peek_train_meta,
)
from multi_modal_normative_modeling_tpu_torch.train.fused import (
    FusedFoldTrainer,
)
from tests.test_torch_endtoend import jax_draws
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_train import _close_trees, _tree, jax_eps_replay

DIMS = [24, 40, 16]
HIDDEN = [12, 12]
Z, C = 6, 5
SIZES = (37, 21)          # fold 1 gets an all-padding third batch
BATCH, EPOCHS = 16, 5
KILLED_AT, EVERY = 3, 2   # the killed run: chunks of 2 and 1 epochs


def _cohorts(c_dim=C):
    rng = np.random.default_rng(3)
    out = []
    for n in SIZES:
        data = [rng.standard_normal((n, d)).astype(np.float32) for d in DIMS]
        cov = rng.standard_normal((n, c_dim)).astype(np.float32)
        extras = {"labels": rng.integers(0, 2, n).astype(np.float32)[:, None],
                  "fi": rng.standard_normal((n, 1)).astype(np.float32)}
        out.append((data, [cov] * len(DIMS), extras))
    return out


def _case(kind, epochs):
    """(model, trainer, batches) of a trainer case, from one seeded init."""
    gen = torch.Generator().manual_seed(0)
    config = TrainConfig(epochs=epochs, batch_size=BATCH, combine="gpoe",
                         lr_schedule="cyclic" if kind == "cyclic"
                         else "constant", shuffle=kind == "shuffle")
    cohorts = _cohorts(2 if kind == "shuffle" else C)
    extra = {"shuffle": "fi", "endtoend": "labels"}.get(kind)
    batches = stack_fold_batches(
        [c[0] for c in cohorts], [c[1] for c in cohorts], BATCH,
        extras=[{extra: c[2][extra]} for c in cohorts] if extra else None)
    state_update = None
    if kind == "shuffle":
        model = RegressionCVAE(DIMS, HIDDEN, Z, 2, len(DIMS), folds=2,
                               generator=gen)
        loss = regression_loss_fn(model, "gpoe")
    elif kind == "endtoend":
        model = EndToEndCVAE(DIMS, HIDDEN, Z, C, len(DIMS),
                             classifier_layers=[16, 8], folds=2,
                             generator=gen)
        config = dataclasses.replace(config, combine="poe")
        loss = endtoend_loss_fn(model, 1.0, 0.5)
        state_update = model.update_state
    else:
        model = build_model("cVAE_multimodal", DIMS, HIDDEN, Z, C, len(DIMS),
                            folds=2, generator=gen)
        loss = (fused_decoder_loss_fn(model, config)
                if kind == "fused_decoder" else None)
    trainer = MultiFoldTrainer(model, config, max(SIZES), loss_fn=loss,
                               state_update=state_update)
    return model, trainer, batches


def _draws(noise, model, batches, shuffle):
    if noise == "fold":
        return {}
    return jax_draws(batches["valid"], EPOCHS, BATCH, model.noise_dim,
                     getattr(model, "keep_widths", ()), shuffle=shuffle)


def _same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _same_logs(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].shape == b[k].shape and np.array_equal(a[k], b[k]), k


KINDS = ["plain", "fused_decoder", "cyclic", "shuffle", "endtoend"]


@pytest.mark.parametrize("noise", ["fold", "replay"])
@pytest.mark.parametrize("kind", KINDS)
def test_multifold_chunks_and_resume_equal_one_run(kind, noise, tmp_path):
    model, trainer, batches = _case(kind, EPOCHS)
    draws = _draws(noise, model, batches, kind == "shuffle")
    logs = trainer.run(batches, **draws)

    # in chunks, without a kill
    chunked, trainer_c, _ = _case(kind, EPOCHS)
    logs_c = trainer_c.run_resumable(batches, tmp_path / "chunked", EVERY,
                                     resume=False, **draws)
    _same_state(chunked, model)
    _same_logs(logs_c, logs)

    # killed after epoch 3, resumed by a fresh trainer from the same init
    _, killed, _ = _case(kind, KILLED_AT)
    killed.run_resumable(batches, tmp_path / "killed", EVERY, resume=False,
                         **draws)
    resumed, trainer_r, _ = _case(kind, EPOCHS)
    logs_r = trainer_r.run_resumable(batches, tmp_path / "killed", EVERY,
                                     resume=True, **draws)
    assert trainer_r.resumed_from == KILLED_AT
    _same_state(resumed, model)
    _same_logs(logs_r, logs)
    if kind == "endtoend":
        # the BatchNorm running statistics came back and moved on
        assert not torch.equal(resumed.classifier.state[0].var,
                               torch.ones_like(resumed.classifier.state[0]
                                               .var))


@pytest.mark.parametrize("kind", ["plain", "endtoend"])
def test_milestones_are_the_runs_of_their_epoch_counts(kind):
    model, trainer, batches = _case(kind, EPOCHS)
    snaps = list(trainer.run_milestones(batches, [2, EPOCHS]))
    assert [m for m, _, _ in snaps] == [2, EPOCHS]
    short, trainer_s, _ = _case(kind, 2)
    logs_s = trainer_s.run(batches)
    for f in range(2):
        _close_trees(snaps[0][1][f], params_to_jax(short, fold=f), rtol=0,
                     atol=0)
        _close_trees(snaps[1][1][f], params_to_jax(model, fold=f), rtol=0,
                     atol=0)
    _same_logs(snaps[0][2], logs_s)
    for k, v in snaps[1][2].items():
        assert v.shape == (2, EPOCHS) and np.array_equal(v[:, :2], logs_s[k])
    with pytest.raises(ValueError, match="milestones must ascend"):
        list(trainer.run_milestones(batches, [3, 2]))


# ---- the fused train step ---------------------------------------------------------

def _fused(precision, epochs):
    dims, hidden, latent = [21, 10], [13, 9], 5
    model = build_model("cVAE_multimodal", dims, hidden, latent, 3,
                        len(dims), folds=2,
                        generator=torch.Generator().manual_seed(0))
    config = TrainConfig(epochs=epochs, batch_size=8, combine="gpoe",
                         precision=precision)
    trainer = FusedFoldTrainer(model, config, 19,
                               tile_b=8 if precision == "bf16" else None)
    rng = np.random.default_rng(1)
    cohorts = [([rng.standard_normal((n, d)).astype(np.float32)
                 for d in dims], rng.standard_normal((n, 3)).astype(
                     np.float32)) for n in (19, 13)]
    batches = trainer.batches([d for d, _ in cohorts],
                              [c for _, c in cohorts], "cpu")
    return trainer, packed_from_model(model, trainer.stacked), batches


def _same_tree(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        assert torch.equal(a, b)


@pytest.mark.parametrize("noise", ["fold", "replay"])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_fused_chunks_and_resume_equal_one_run(precision, noise, tmp_path):
    trainer, packed, batches = _fused(precision, EPOCHS)
    eps = None
    if noise == "replay":
        eps = np.random.default_rng(2).standard_normal(
            (EPOCHS * batches.n_batches, 2, 8, 5)).astype(np.float32)
    trained, logs = trainer.run(packed, batches, eps=eps)
    killed, packed_k, batches_k = _fused(precision, KILLED_AT)
    killed.run_resumable(packed_k, batches_k, tmp_path, EVERY, resume=False,
                         eps=eps)
    fresh, packed_r, batches_r = _fused(precision, EPOCHS)
    trained_r, logs_r = fresh.run_resumable(packed_r, batches_r, tmp_path,
                                            EVERY, resume=True, eps=eps)
    assert fresh.resumed_from == KILLED_AT
    _same_tree(trained_r, trained)
    _same_logs(logs_r, logs)
    assert peek_train_meta(tmp_path) == {
        "loss": "fused_kernel_" + ("tiled" if precision == "bf16"
                                   else "single"),
        "precision": precision, "batch": "8"}


# ---- the state on disk, and refusals ----------------------------------------------

def test_epoch_cursor_lives_in_the_blob_and_stale_tmp_is_ignored(tmp_path):
    model, trainer, batches = _case("plain", EPOCHS)
    logs = trainer.run(batches)
    _, killed, _ = _case("plain", KILLED_AT)
    killed.run_resumable(batches, tmp_path, EVERY, resume=False)
    assert json.loads((tmp_path / "train_state.json").read_text()) == {
        "epoch": KILLED_AT}
    tensors, epoch, stored_logs = load_train_state(tmp_path)
    assert epoch == KILLED_AT
    assert stored_logs["total"].shape == (2, KILLED_AT)
    assert len(tensors["noise"]) == 2 and tensors["buffers"] == {}
    # the sidecar is informational, and a torn tmp of a killed write is
    # never read
    (tmp_path / "train_state.json").write_text(json.dumps({"epoch": 0}))
    (tmp_path / ".train_state.ckpt.4242.tmp").write_bytes(b"\x00torn")
    resumed, trainer_r, _ = _case("plain", EPOCHS)
    logs_r = trainer_r.run_resumable(batches, tmp_path, EVERY, resume=True)
    assert trainer_r.resumed_from == KILLED_AT
    _same_state(resumed, model)
    _same_logs(logs_r, logs)


def test_resume_of_a_finished_run_trains_nothing(tmp_path):
    model, trainer, batches = _case("plain", EPOCHS)
    logs = trainer.run_resumable(batches, tmp_path, EVERY, resume=False)
    again, trainer_a, _ = _case("plain", EPOCHS)
    logs_a = trainer_a.run_resumable(batches, tmp_path, EVERY, resume=True)
    assert trainer_a.resumed_from == EPOCHS
    _same_state(again, model)
    _same_logs(logs_a, logs)


REFUSAL = "refusing to resume .*a mixed-numerics trajectory would match"


def test_resume_under_another_loss_or_batch_is_refused(tmp_path):
    _, trainer, batches = _case("plain", KILLED_AT)
    trainer.run_resumable(batches, tmp_path, EVERY, resume=False)
    assert peek_train_meta(tmp_path) == {"loss": "default_loss_fn",
                                         "precision": "fp32",
                                         "remat": "False", "batch": "16"}
    _, other, _ = _case("fused_decoder", EPOCHS)
    with pytest.raises(ValueError, match=REFUSAL):
        other.run_resumable(batches, tmp_path, EVERY, resume=True)
    model = build_model("cVAE_multimodal", DIMS, HIDDEN, Z, C, len(DIMS),
                        folds=2)
    config = TrainConfig(epochs=EPOCHS, batch_size=8, combine="gpoe")
    cohorts = _cohorts()
    with pytest.raises(ValueError, match=REFUSAL):
        MultiFoldTrainer(model, config, max(SIZES)).run_resumable(
            stack_fold_batches([c[0] for c in cohorts],
                               [c[1] for c in cohorts], 8),
            tmp_path, EVERY, resume=True)


def test_resume_under_another_precision_or_kernel_is_refused(tmp_path):
    trainer, packed, batches = _fused("fp32", KILLED_AT)
    trainer.run_resumable(packed, batches, tmp_path, EVERY, resume=False)
    other, packed_o, batches_o = _fused("bf16", EPOCHS)
    with pytest.raises(ValueError, match=REFUSAL):
        other.run_resumable(packed_o, batches_o, tmp_path, EVERY, resume=True)


def test_a_jax_train_state_is_refused(tmp_path):
    key = jax.random.PRNGKey(42)
    jax_save_train_state(tmp_path, {"w": np.zeros((2, 3), np.float32)},
                         {"mu": np.zeros((2, 3), np.float32)}, key, 2,
                         logs={"total": np.zeros((2, 2), np.float32)},
                         meta={"loss": "default_loss_fn",
                               "precision": "fp32", "batch": "16"})
    _, trainer, batches = _case("plain", EPOCHS)
    with pytest.raises(ValueError, match="not written by the torch port "
                                         r"\(it is the JAX package's"):
        trainer.run_resumable(batches, tmp_path, EVERY, resume=True)


def test_checkpoint_every_must_be_positive(tmp_path):
    _, trainer, batches = _case("plain", EPOCHS)
    with pytest.raises(ValueError, match="checkpoint_every must be >= 1"):
        trainer.run_resumable(batches, tmp_path, 0)


# ---- against the JAX package --------------------------------------------------------

def test_milestones_and_resume_match_jax(tmp_path):
    """JAX MultiFoldTrainer's run_milestones and run_resumable (killed and
    resumed) against the port's, from the JAX init and noise."""
    jmodel, tree = _tree()
    cohorts = _cohorts()
    data, cov = [c[0] for c in cohorts], [c[1] for c in cohorts]
    jconfig = JaxConfig(epochs=EPOCHS, batch_size=BATCH, combine="gpoe")
    jbatches = jax.device_put(jax_stack_fold_batches(data, cov, BATCH))
    key = jax.random.PRNGKey(42)
    keys = jnp.stack([key, key])
    stacked = jax_stack_params([tree, tree])
    ref_snaps = list(JaxMultiFoldTrainer(jmodel, jconfig, max(SIZES))
                     .run_milestones(stacked, jbatches, keys, [2, EPOCHS]))
    JaxMultiFoldTrainer(jmodel, dataclasses.replace(jconfig,
                                                    epochs=KILLED_AT),
                        max(SIZES)).run_resumable(
        stacked, jbatches, keys, tmp_path / "jax", EVERY, resume=False)
    ref_params, ref_logs = JaxMultiFoldTrainer(
        jmodel, jconfig, max(SIZES)).run_resumable(
            stacked, jbatches, keys, tmp_path / "jax", EVERY, resume=True)

    batches = stack_fold_batches(data, cov, BATCH)
    eps = jax_eps_replay(batches["valid"], EPOCHS, BATCH, Z)

    def port(epochs):
        from tests.test_torch_train import _port

        model = _port(tree, folds=2)
        config = TrainConfig(epochs=epochs, batch_size=BATCH, combine="gpoe")
        return model, MultiFoldTrainer(model, config, max(SIZES))

    _, trainer = port(EPOCHS)
    snaps = list(trainer.run_milestones(batches, [2, EPOCHS], eps=eps))
    for (m, params, logs), (rm, rparams, rlogs) in zip(snaps, ref_snaps):
        assert m == rm
        for k in ("total", "kl", "ll"):
            np.testing.assert_allclose(logs[k], np.asarray(rlogs[k]),
                                       rtol=1e-4)
        for f in range(2):
            _close_trees(params[f], jax.tree_util.tree_map(
                lambda a, f=f: a[f], rparams), rtol=5e-3, atol=1e-5)
    _, killed = port(KILLED_AT)
    killed.run_resumable(batches, tmp_path / "port", EVERY, resume=False,
                         eps=eps)
    model, resumed = port(EPOCHS)
    logs = resumed.run_resumable(batches, tmp_path / "port", EVERY,
                                 resume=True, eps=eps)
    for k in ("total", "kl", "ll"):
        np.testing.assert_allclose(logs[k], np.asarray(ref_logs[k]),
                                   rtol=1e-4)
    _close_trees(params_to_jax(model), ref_params, rtol=5e-3, atol=1e-5)


# ---- kill and resume through the CLIs ---------------------------------------------

MODEL_DIR = "outputs/kfold_analysis/supervised_cvae"


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("resume_data")
    make_synthetic_resource(root, "ADNI", n_hc=30, n_disease={0: 11, 1: 10},
                            with_fi=True, with_early_fusion=True)
    return root / "data"


def _train_args(epochs, **extra):
    return argparse.Namespace(
        dataset_resourse="ADNI", hz_para_list=[16, 16, 4],
        procedure="SE-MoE", combine="MoE", epochs=epochs, n_splits=2,
        oversample_percentage=1, model="cVAE_multimodal",
        single_modality=None, base_learning_rate=0.0001,
        max_learning_rate=0.005, training_class="nm",
        lr_schedule="constant", fold_parallel=True, precision="fp32",
        batch_size=16, device="cpu", **extra)


COMMON = ["-R", "ADNI", "-K", "2", "-H", "16", "16", "4", "--device", "cpu"]
CLIS = {
    "train": ({}, None),
    "train --fused_decoder": ({"fused_decoder": True}, None),
    "train --fused_train_step": ({"fused_train_step": True}, None),
    "nmpmcont": (COMMON + ["-P", "SE-MoE", "-Layers", "16", "8"], MODEL_DIR),
    "nmmlp": (["train"] + COMMON + ["-P", "SE-MoE"], MODEL_DIR),
    "regression": (COMMON + ["-P", "UCA-gPoE", "--batch_size", "16"],
                   "regression_outputs"),
}


def _run_cli(name, root, epochs, *flags):
    spec, _ = CLIS[name]
    if name.startswith("train"):
        extra = dict(spec)
        if flags:
            extra.update(checkpoint_every=flags[0],
                         resume=len(flags) > 1)
        train_supervised.main(_train_args(epochs, **extra), project_root=root)
        return
    argv = spec + ["-E", str(epochs)]
    if flags:
        argv += ["--checkpoint_every", str(flags[0])]
        argv += ["--resume"] if len(flags) > 1 else []
    module = {"nmpmcont": nmpmcont, "nmmlp": nmmlp,
              "regression": regression}[name]
    if name == "nmpmcont":
        nmpmcont.run(argv, project_root=root)
    else:
        module.run(argv, project_root=root)


def _checkpoint_files(root, name):
    if name == "regression":
        # the regression writes no checkpoint: its trained state is in the
        # predictions and the ROI deviations
        return sorted((root / "regression_outputs").glob("*.npy")) + sorted(
            (root / "regression_outputs").glob("*roiwise.csv"))
    return sorted((root / MODEL_DIR).glob("*/cVAE_model.ckpt"))


@pytest.mark.parametrize("name", list(CLIS))
def test_kill_and_resume_through_the_cli_is_byte_equal(name, cohort,
                                                        tmp_path):
    roots = {}
    for run in ("straight", "resumed"):
        roots[run] = tmp_path / run
        shutil.copytree(cohort, roots[run] / "data")
    _run_cli(name, roots["straight"], 4)
    _run_cli(name, roots["resumed"], 2, 2)
    _run_cli(name, roots["resumed"], 4, 2, True)
    state_dir = roots["resumed"] / (CLIS[name][1] or MODEL_DIR)
    if name == "train --fused_train_step":
        state_dir = state_dir / "fused-state"
    assert json.loads((state_dir / "train_state.json").read_text()) == {
        "epoch": 4}
    straight = _checkpoint_files(roots["straight"], name)
    resumed = _checkpoint_files(roots["resumed"], name)
    assert len(straight) >= 2
    assert ([p.relative_to(roots["straight"]) for p in straight]
            == [p.relative_to(roots["resumed"]) for p in resumed])
    for a, b in zip(straight, resumed):
        assert a.read_bytes() == b.read_bytes(), a.name
    if name.startswith("train"):
        events = [json.loads(line) for line in
                  (roots["resumed"] / MODEL_DIR / "run_log.jsonl")
                  .read_text().splitlines()]
        assert events[-1]["resumed_from"] == 2
        assert events[-1]["checkpoint_every"] == 2
