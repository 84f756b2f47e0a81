"""The port's train CLI against the JAX train CLI, on the CPU.

A tiny synthetic ADNI cohort (SE-MoE, 3 modalities, 2 folds of 25 and 26
subjects, batch 5, so one fold trains on an all-padding batch every epoch)
is trained by the JAX CLI and by the port's CLI (``--device cpu``, with and
without ``--fused_decoder``) from the JAX init and the JAX noise stream. The
port must write the same fold-id files and checkpoints that hold the JAX
parameters within the trajectory bound of tests/test_decoder_nll.py:129-133
(rtol 5e-3 / atol 1e-5); the JAX test stage and the port's test stage then
both score the port's checkpoints."""
import argparse
import json
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
from multi_modal_normative_modeling_tpu_torch.cli import (
    test_supervised as port_test,
    train_supervised as port_train,
)
from multi_modal_normative_modeling_tpu_torch.interop import (
    params_from_jax,
    read_flax_checkpoint,
)
from multi_modal_normative_modeling_tpu_torch.parallel import stack_params
from tests.test_torch_train import jax_eps_replay

MODEL_DIR = "outputs/kfold_analysis/supervised_cvae"


def _args(**extra):
    return argparse.Namespace(
        dataset_resourse="ADNI", hz_para_list=[16, 16, 4],
        procedure="SE-MoE", combine="MoE", epochs=3, n_splits=2,
        oversample_percentage=1, model="cVAE_multimodal",
        single_modality=None, base_learning_rate=0.0001,
        max_learning_rate=0.005, training_class="nm",
        lr_schedule="constant", fold_parallel=True, precision="fp32",
        batch_size=5, **extra)


def _jax_init(model):
    """The JAX CLI's init (PRNGKey(42), the same for every fold)."""
    jmodel = jax_build("cVAE_multimodal", model.input_dim_list,
                       model.hidden_dim, model.latent_dim, model.c_dim,
                       model.modalities)
    tree = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(42)))
    params_from_jax(stack_params([tree] * model.folds), model)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("train_cli")
    make_synthetic_resource(base / "jax", "ADNI", n_hc=30,
                            n_disease={0: 11, 1: 10})
    jax_train.main(_args(), project_root=base / "jax")
    out = {"jax": base / "jax"}
    for name, extra in (("port", {}), ("port_fused", {"fused_decoder": True})):
        out[name] = base / name
        shutil.copytree(base / "jax" / "data", out[name] / "data")
        port_train.main(_args(device="cpu", **extra), project_root=out[name],
                        init_fn=_jax_init, eps_fn=jax_eps_replay)
    return out


@pytest.mark.parametrize("port", ["port", "port_fused"])
def test_train_cli_matches_jax(roots, port):
    for f in range(2):
        for kind in ("train", "test"):
            rel = f"outputs/kfold_analysis/{kind}_ids_{f:03d}.csv"
            assert ((roots[port] / rel).read_bytes()
                    == (roots["jax"] / rel).read_bytes())
        ref, ref_config = read_flax_checkpoint(roots["jax"] / MODEL_DIR
                                               / f"{f:03d}")
        got, config = read_flax_checkpoint(roots[port] / MODEL_DIR
                                           / f"{f:03d}")
        assert config == ref_config
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(ref)):
            np.testing.assert_allclose(a, b, rtol=5e-3, atol=1e-5)
    sizes = [len(pd.read_csv(roots[port] / "outputs/kfold_analysis"
                             / f"train_ids_{f:03d}.csv")) for f in range(2)]
    assert sorted(sizes) == [25, 26]


def test_train_cli_writes_logs_and_plots(roots):
    model_dir = roots["port"] / MODEL_DIR
    events = [json.loads(line)["event"] for line in
              (model_dir / "run_log.jsonl").read_text().splitlines()]
    assert events == ["train_start", "fold_done", "fold_done", "train_end"]
    for f in range(2):
        assert (model_dir / f"{f:03d}" / "Lossestraining.png").exists()


def test_jax_and_port_test_stages_score_port_checkpoints(roots, tmp_path):
    shutil.copytree(roots["port_fused"], tmp_path / "jax_scored")
    shutil.copytree(roots["port_fused"], tmp_path / "port_scored")
    jax_test.main(_args(), project_root=tmp_path / "jax_scored")
    port_test.main(_args(device="cpu"), project_root=tmp_path / "port_scored")
    for root in ("jax_scored", "port_scored"):
        dev = (tmp_path / root / "deviation" / "supervised_cvae" / "ADNI"
               / "SE-MoE" / "path_model" / "av45"
               / "reconstruction_error_av45.csv")
        values = pd.read_csv(dev).select_dtypes("number").to_numpy()
        assert values.size and np.isfinite(values).all()


def test_default_init_repeats_one_seeded_fold():
    from multi_modal_normative_modeling_tpu_torch.models import build_model

    def make():
        model = build_model("cVAE_multimodal", [9, 7], [5], 3, 4, 2, folds=3)
        port_train.default_init(model)
        return model

    a, b = make(), make()
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
        assert torch.equal(va[0], va[2]), k


@pytest.mark.parametrize("flag,value", [
    ("mesh", "2,4"), ("ep_mesh", "4,2"), ("packed_xla", True),
    ("fused_train_step", True), ("stream_shards", 2),
    ("checkpoint_every", 5), ("resume", True), ("remat", True),
    ("in_memory_fusion", True), ("profile_dir", "trace"),
    ("warmup_only", True), ("precision", "bf16")])
def test_unported_flags_raise(flag, value, tmp_path):
    args = _args(device="cpu")
    setattr(args, flag, value)
    with pytest.raises(SystemExit, match="ROADMAP.md"):
        port_train.main(args, project_root=tmp_path)
    assert not (tmp_path / "outputs").exists()


def test_parser_takes_the_jax_flags_and_defaults_to_cuda():
    args = port_train.build_parser().parse_args(
        ["-R", "ADNI", "-E", "3", "--fused_decoder", "--fold_parallel",
         "--no_fused_heads", "--lr_schedule", "cyclic", "--batch_size", "64"])
    assert args.device == "cuda" and args.fused_decoder
    assert args.batch_size == 64 and args.lr_schedule == "cyclic"
