"""Out-of-core streamed training in the port (train/streaming.py), on the
CPU.

Against the JAX package's StreamingFoldTrainer (the shapes of
tests/test_streaming.py:20-55: widths [24, 16], hidden [12, 12], latent 6,
c 5, 70 rows, batch 16, 4 epochs) from the same init, the port replaying
JAX's noise, at S = 1, 2 and 3: logs rtol 1e-4, parameters rtol 5e-3 / atol
1e-5 (the trajectory bounds of tests/test_torch_train.py). Against the
port's resident MultiFoldTrainer: bit-equal (logs and parameters equal) at
every shard count, on the plain loss and on the plain version of the K4
loss, and through kill and resume both ways between the two trainers.
``split_shards`` / ``shard_plan`` equal JAX's over a table of inputs; the
shard count clamps to the batch count; shuffle is refused with JAX's
message.

Through the train CLI (a tiny ADNI cohort, SE-MoE, 2 folds, batch 5): the
``--stream_shards 2`` checkpoints against the JAX CLI's (rtol 5e-3 / atol
1e-5) and byte-equal to the port's resident run; ``-1``'s printed line and
the conflict messages equal the JAX CLI's.
"""
import argparse
import re
import shutil
import weakref

import jax
import numpy as np
import pytest
import torch

from multi_modal_normative_modeling_tpu import train as jax_train_pkg
from multi_modal_normative_modeling_tpu.cli import (
    train_supervised as jax_train_cli,
)
from multi_modal_normative_modeling_tpu.data.synthetic import (
    make_synthetic_resource,
)
from multi_modal_normative_modeling_tpu.models import build_model as jax_build
from multi_modal_normative_modeling_tpu.train import TrainConfig as JaxConfig
from multi_modal_normative_modeling_tpu.train import make_batches as jax_mb
from multi_modal_normative_modeling_tpu.train.streaming import (
    StreamingFoldTrainer as JaxStreamingFoldTrainer,
    shard_plan as jax_shard_plan,
    split_shards as jax_split_shards,
)
from multi_modal_normative_modeling_tpu_torch.cli import (
    train_supervised as port_train_cli,
)
from multi_modal_normative_modeling_tpu_torch.interop import (
    params_from_jax,
    params_to_jax,
    read_flax_checkpoint,
)
from multi_modal_normative_modeling_tpu_torch.kernels.decoder_nll import (
    fused_decoder_loss_fn,
)
from multi_modal_normative_modeling_tpu_torch.models import build_model
from multi_modal_normative_modeling_tpu_torch.parallel import (
    MultiFoldTrainer,
    stack_fold_batches,
    stack_params,
)
from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
from multi_modal_normative_modeling_tpu_torch.train.streaming import (
    StreamedBatches,
    StreamingFoldTrainer,
    shard_plan,
    split_shards,
)
from multi_modal_normative_modeling_tpu_torch.train.trainer import (
    make_batches,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_train import jax_eps_replay

DIMS = [24, 16]
HIDDEN = [12, 12]
Z, C = 6, 5
N, BATCH, EPOCHS = 70, 16, 4
LOG_TOL = dict(rtol=1e-4)
PARAM_TOL = dict(rtol=5e-3, atol=1e-5)
MODEL_DIR = "outputs/kfold_analysis/supervised_cvae"


def _problem(n=N, seed=0):
    """The JAX model, its init tree, one fold's data and covariates."""
    rng = np.random.default_rng(seed)
    jmodel = jax_build("cVAE_multimodal", DIMS, HIDDEN, Z, C, len(DIMS))
    tree = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(0)))
    data = [rng.normal(size=(n, d)).astype(np.float32) for d in DIMS]
    cov = [rng.normal(size=(n, C)).astype(np.float32)] * len(DIMS)
    return jmodel, tree, data, cov


def _port(tree, folds=1):
    model = build_model("cVAE_multimodal", DIMS, HIDDEN, Z, C, len(DIMS),
                        folds=folds)
    return params_from_jax(stack_params([tree] * folds), model)


def _same(model_a, logs_a, model_b, logs_b):
    for k in logs_b:
        np.testing.assert_array_equal(logs_a[k], logs_b[k], err_msg=k)
    for (k, a), b in zip(model_a.state_dict().items(),
                         model_b.state_dict().values()):
        assert torch.equal(a, b), k


@pytest.fixture(scope="module")
def jax_streamed():
    """JAX StreamingFoldTrainer at each shard count, from PRNGKey(42)."""
    jmodel, tree, data, cov = _problem()
    config = JaxConfig(epochs=EPOCHS, batch_size=BATCH, combine="gpoe")
    return {s: jax.tree_util.tree_map(
        np.asarray, JaxStreamingFoldTrainer(jmodel, config, N, shards=s).run(
            tree, data, cov)) for s in (1, 2, 3)}


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_streaming_matches_jax(shards, jax_streamed):
    _, tree, data, cov = _problem()
    ref_params, ref_logs = jax_streamed[shards]
    model = _port(tree)
    batches = stack_fold_batches([data], [cov], BATCH)
    trainer = StreamingFoldTrainer(
        model, TrainConfig(epochs=EPOCHS, batch_size=BATCH, combine="gpoe"),
        N, shards=shards)
    logs = trainer.run(batches, eps=jax_eps_replay(batches["valid"], EPOCHS,
                                                   BATCH, Z))
    for k in ("total", "kl", "ll"):
        np.testing.assert_allclose(logs[k][0], ref_logs[k], **LOG_TOL)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_jax(model, fold=0)),
                    jax.tree_util.tree_leaves(ref_params)):
        np.testing.assert_allclose(a, b, **PARAM_TOL)


def _two_folds(seed=3):
    """Two folds of 70 and 37 rows: the small one trains on all-padding
    batches (padding batches and a ragged last batch in a shard)."""
    rng = np.random.default_rng(seed)
    data = [[rng.normal(size=(n, d)).astype(np.float32) for d in DIMS]
            for n in (N, 37)]
    cov = [[rng.normal(size=(n, C)).astype(np.float32)] * len(DIMS)
           for n in (N, 37)]
    return stack_fold_batches(data, cov, BATCH)


def _run(batches, shards=None, fused=False, epochs=EPOCHS, **draws):
    _, tree, _, _ = _problem()
    model = _port(tree, folds=2)
    config = TrainConfig(epochs=epochs, batch_size=BATCH, combine="gpoe")
    loss = fused_decoder_loss_fn(model, config) if fused else None
    if shards is None:
        trainer = MultiFoldTrainer(model, config, N, loss_fn=loss)
    else:
        trainer = StreamingFoldTrainer(model, config, N, shards=shards,
                                       loss_fn=loss)
    return model, trainer.run(batches, **draws)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "k4_plain"])
@pytest.mark.parametrize("shards", [1, 2, 3, 5])
def test_streaming_bit_equal_to_resident(shards, fused):
    batches = _two_folds()
    assert batches["mask"].shape[1] == 5
    assert not batches["valid"][1, -1]
    _same(*_run(batches, shards, fused), *_run(batches, None, fused))


def test_streaming_with_replayed_noise_equals_resident():
    batches = _two_folds()
    eps = jax_eps_replay(batches["valid"], EPOCHS, BATCH, Z)
    _same(*_run(batches, 2, eps=eps), *_run(batches, eps=eps))


def test_shard_count_clamps_to_the_batch_count():
    batches = _two_folds()
    streamed = StreamedBatches(batches, 8, "cpu")
    assert streamed.shards == 5 and streamed.n_batches == 5
    _same(*_run(batches, 8, epochs=2), *_run(batches, 1, epochs=2))


def test_uploads_follow_the_chunk():
    """S > 1 uploads every shard once per epoch and nothing after the
    chunk's last step; S = 1 uploads once for the whole run."""
    batches = _two_folds()
    for shards, want in ((3, 3 * EPOCHS), (1, 1)):
        _, tree, _, _ = _problem()
        trainer = StreamingFoldTrainer(
            _port(tree, folds=2),
            TrainConfig(epochs=EPOCHS, batch_size=BATCH), N, shards=shards)
        streamed = trainer.streamed(batches)
        trainer.run(streamed)
        assert streamed.uploads == want
        assert not streamed._dev or shards == 1


@pytest.mark.parametrize("shards", [2, 5])
def test_at_most_inflight_shards_are_alive(shards, monkeypatch):
    """When a shard is uploaded, no buffer of a shard before the one that
    computes is still referenced (by the view or by the epoch loop's last
    batch): the card holds two shards, not three."""
    placed = StreamedBatches._placed
    alive, peak = [], [0]

    def counting(self, host, lo, block):
        out = placed(self, host, lo, block)
        alive.append(weakref.ref(out._base))
        peak[0] = max(peak[0], sum(r() is not None for r in alive))
        return out

    monkeypatch.setattr(StreamedBatches, "_placed", counting)
    batches = _two_folds()
    _run(batches, shards)
    leaves = 2 * len(DIMS)   # x and c of every modality
    assert peak[0] == 2 * leaves


def test_streaming_rejects_shuffle_and_bad_counts():
    _, tree, _, _ = _problem()
    model = _port(tree)
    with pytest.raises(ValueError) as port_exc:
        StreamingFoldTrainer(model, TrainConfig(epochs=1, batch_size=BATCH,
                                                shuffle=True), N)
    jmodel = _problem()[0]
    with pytest.raises(ValueError) as jax_exc:
        JaxStreamingFoldTrainer(jmodel, JaxConfig(epochs=1, batch_size=BATCH,
                                                  shuffle=True), N)
    assert str(port_exc.value) == str(jax_exc.value)
    for kwargs in ({"shards": 0}, {"inflight": 0}):
        with pytest.raises(ValueError) as port_exc:
            StreamingFoldTrainer(model, TrainConfig(epochs=1), N, **kwargs)
        with pytest.raises(ValueError) as jax_exc:
            JaxStreamingFoldTrainer(jmodel, JaxConfig(epochs=1), N, **kwargs)
        assert str(port_exc.value) == str(jax_exc.value)


@pytest.mark.parametrize("rows,shards", [(50, 1), (50, 3), (50, 7), (16, 1),
                                         (129, 4), (129, 9), (50, 0),
                                         (50, 8)])
def test_split_shards_matches_jax(rows, shards):
    data = [np.arange(rows * 4, dtype=np.float32).reshape(rows, 4)]
    cov = [np.ones((rows, 3), np.float32)]
    port, ref = make_batches(data, cov, 8), jax_mb(data, cov, 8)
    if not 1 <= shards <= port["mask"].shape[0]:
        with pytest.raises(ValueError) as port_exc:
            split_shards(port, shards)
        with pytest.raises(ValueError) as jax_exc:
            jax_split_shards(ref, shards)
        assert str(port_exc.value) == str(jax_exc.value)
        return
    got, want = split_shards(port, shards), jax_split_shards(ref, shards)
    assert len(got) == len(want) == shards
    for g, w in zip(got, want):
        for a, b in zip(jax.tree_util.tree_leaves(g),
                        jax.tree_util.tree_leaves(w)):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_shard_plan_matches_jax():
    gb = 1 << 30
    for total in (0, -1, 1, 7 * gb, 8 * gb, 8 * gb + 1, 20 * gb, 129 * gb):
        for budget in (0, 1, gb, 16 * gb, 40 * gb):
            assert shard_plan(total, budget) == jax_shard_plan(total, budget)


@pytest.mark.parametrize("first", ["resident", "streamed"])
def test_kill_and_resume_across_the_two_trainers(first, tmp_path):
    """A run killed after epoch 2 of 6 on one trainer and resumed on the
    other equals the straight resident run bit for bit."""
    batches = _two_folds(seed=5)
    want = _run(batches, epochs=6)

    def trainer(streamed, epochs):
        _, tree, _, _ = _problem()
        model = _port(tree, folds=2)
        config = TrainConfig(epochs=epochs, batch_size=BATCH, combine="gpoe")
        if streamed:
            return model, StreamingFoldTrainer(model, config, N, shards=2)
        return model, MultiFoldTrainer(model, config, N)

    _, killed = trainer(first == "streamed", 2)
    killed.run_resumable(batches, tmp_path, 2, resume=False)
    model, resumed = trainer(first != "streamed", 6)
    logs = resumed.run_resumable(batches, tmp_path, 2, resume=True)
    assert resumed.resumed_from == 2
    _same(model, logs, *want)


# ---- the train CLI --------------------------------------------------------

def _cli_args(**extra):
    return argparse.Namespace(**{**dict(
        dataset_resourse="ADNI", hz_para_list=[16, 16, 4],
        procedure="SE-MoE", combine="MoE", epochs=3, n_splits=2,
        oversample_percentage=1, model="cVAE_multimodal",
        single_modality=None, base_learning_rate=0.0001,
        max_learning_rate=0.005, training_class="nm",
        lr_schedule="constant", fold_parallel=False, precision="fp32",
        batch_size=5), **extra})


def _jax_init(model):
    jmodel = jax_build("cVAE_multimodal", model.input_dim_list,
                       model.hidden_dim, model.latent_dim, model.c_dim,
                       model.modalities)
    tree = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(42)))
    params_from_jax(stack_params([tree] * model.folds), model)


@pytest.fixture(scope="module")
def cli_roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("stream_cli")
    make_synthetic_resource(base / "jax", "ADNI", n_hc=30,
                            n_disease={0: 11, 1: 10})
    jax_train_cli.main(_cli_args(stream_shards=2), project_root=base / "jax")
    out = {"jax": base / "jax"}
    for name, extra in (("streamed", {"stream_shards": 2}),
                        ("resident", {})):
        out[name] = base / name
        shutil.copytree(base / "jax" / "data", out[name] / "data")
        port_train_cli.main(_cli_args(device="cpu", **extra),
                            project_root=out[name], init_fn=_jax_init,
                            eps_fn=jax_eps_replay)
    return out


def test_cli_streamed_checkpoints_match_jax_and_the_resident_run(cli_roots):
    for f in range(2):
        rel = f"{MODEL_DIR}/{f:03d}/cVAE_model.ckpt"
        assert ((cli_roots["streamed"] / rel).read_bytes()
                == (cli_roots["resident"] / rel).read_bytes())
        ref, ref_config = read_flax_checkpoint(cli_roots["jax"] / MODEL_DIR
                                               / f"{f:03d}")
        got, config = read_flax_checkpoint(cli_roots["streamed"] / MODEL_DIR
                                           / f"{f:03d}")
        assert config == ref_config
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(ref)):
            np.testing.assert_allclose(a, b, **PARAM_TOL)


class _Stop(Exception):
    pass


def test_cli_auto_line_equals_jax(cli_roots, tmp_path, capsys, monkeypatch):
    """-1 prints JAX's line, from fold 0's bytes and the 16 GiB default
    budget off the card (JAX's default where the device reports none)."""
    def stop(*args, **kwargs):
        raise _Stop

    monkeypatch.setattr(jax_train_pkg, "StreamingFoldTrainer", stop)
    shutil.copytree(cli_roots["jax"] / "data", tmp_path / "jax" / "data")
    with pytest.raises(_Stop):
        jax_train_cli.main(_cli_args(stream_shards=-1),
                           project_root=tmp_path / "jax")
    want = [line for line in capsys.readouterr().out.splitlines()
            if line.startswith("--stream_shards auto")]
    shutil.copytree(cli_roots["jax"] / "data", tmp_path / "port" / "data")
    port_train_cli.main(_cli_args(stream_shards=-1, device="cpu", epochs=1),
                        project_root=tmp_path / "port")
    got = [line for line in capsys.readouterr().out.splitlines()
           if line.startswith("--stream_shards auto")]
    assert len(want) == 1 and got == want
    assert re.fullmatch(r"--stream_shards auto: \d+ MiB batch data vs 8192 "
                        r"MiB budget -> 1 shard\(s\)", got[0])


@pytest.mark.parametrize("extra", [
    {"fold_parallel": True},
    {"packed_xla": True},
    {"fused_train_step": True},
    {"fold_parallel": True, "packed_xla": True},
    {"stream_shards": -3},
], ids=["fold_parallel", "packed_xla", "fused_train_step", "two", "below"])
def test_cli_conflicts_exit_with_the_jax_message(extra, cli_roots, tmp_path):
    messages = []
    for name, main, more in (("jax", jax_train_cli.main, {}),
                             ("port", port_train_cli.main,
                              {"device": "cpu"})):
        shutil.copytree(cli_roots["jax"] / "data", tmp_path / name / "data")
        args = _cli_args(**{"stream_shards": 2, **extra, **more})
        with pytest.raises(SystemExit) as exc:
            main(args, project_root=tmp_path / name)
        messages.append(str(exc.value))
    assert messages[0] == messages[1]
    assert "--stream_shards" in messages[1]
    # as in the JAX CLI, after the data prep and before any training
    assert not list((tmp_path / "port").glob(f"{MODEL_DIR}/*/*.ckpt"))
