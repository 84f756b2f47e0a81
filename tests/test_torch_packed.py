"""The padded packed layout and the ``--packed_xla`` routing against the
JAX package, on the CPU.

The port's ``PackedMultiFoldTrainer`` trains every fold at once; it is held
to the JAX package's sequential per-fold packed trainer
(``train/packed.py::PackedFoldTrainer``), both starting from the same JAX
init and drawing the same noise (the JAX stream replayed through
``tests.test_torch_endtoend.jax_draws``). Two folds of different sizes (37
and 21 subjects in batches of 16) make the small fold meet an all-padding
batch in the port's stacked grid every epoch. Bounds are
tests/test_packed_cli.py's: every logged term rtol 2e-4, parameters rtol
5e-3 / atol 5e-5; bf16 against JAX bf16 at rtol 2e-2. The routing
(``packed_supported``, ``select_packed_trainer``) and its printed texts are
the JAX package's for every registry model, width pattern and precision;
the train CLI's ``--packed_xla`` run writes the JAX CLI's files.

The helpers here serve tests/test_torch_grouped.py and
tests/test_torch_packed_variants.py too.
"""
import argparse
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_normative_modeling_tpu.cli import (
    train_supervised as jax_train_cli,
)
from multi_modal_normative_modeling_tpu.data.synthetic import (
    make_synthetic_resource,
)
from multi_modal_normative_modeling_tpu.models import build_model as jax_build
from multi_modal_normative_modeling_tpu.models.multimodal import (
    MultimodalCVAE as JaxMultimodalCVAE,
)
from multi_modal_normative_modeling_tpu.train import TrainConfig as JaxConfig
from multi_modal_normative_modeling_tpu.train import grouped as jax_grouped
from multi_modal_normative_modeling_tpu.train import packed as jax_packed
from multi_modal_normative_modeling_tpu_torch.cli import (
    train_supervised as port_train_cli,
)
from multi_modal_normative_modeling_tpu_torch.interop import (
    params_from_jax,
    params_to_jax,
    read_flax_checkpoint,
)
from multi_modal_normative_modeling_tpu_torch.models import (
    MultimodalCVAE,
    build_model,
)
from multi_modal_normative_modeling_tpu_torch.parallel import (
    stack_fold_batches,
    stack_params,
)
from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
from multi_modal_normative_modeling_tpu_torch.train import grouped, packed
from tests.test_torch_endtoend import jax_draws
from tests.test_torch_threads import one_torch_thread  # noqa: F401

C, HIDDEN = 4, [10, 8]
SIZES, EPOCHS, BATCH = (37, 21), 4, 16
LOG_TOL = dict(rtol=2e-4)
PARAM_TOL = dict(rtol=5e-3, atol=5e-5)
REGISTRY_NAMES = ("cVAE_multimodal", "mmJSD", "mvtCAE", "DMVAE",
                  "WeightedDMVAE", "mmVAEPlus")


# ---- helpers shared by the packed test files --------------------------------

def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def make_jax_port(name, dims, z, c_dim=C, hidden=HIDDEN, extra=None,
                  folds=2, seed=0, jax_cls=None, port_cls=None):
    """(JAX model, its init tree, the port's fold-stacked model holding that
    tree in every fold, as the CLIs start every fold). ``name`` is a
    registry name or a skeleton variant; ``jax_cls``/``port_cls`` build
    another family with the same arguments."""
    extra = extra or {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the empty shared code
        if jax_cls is not None:
            jmodel = jax_cls(dims, hidden, z, c_dim, len(dims), **extra)
            model = port_cls(dims, hidden, z, c_dim, len(dims), folds=folds,
                             **extra)
        elif name in REGISTRY_NAMES:
            jmodel = jax_build(name, dims, hidden, z, c_dim, len(dims))
            model = build_model(name, dims, hidden, z, c_dim, len(dims),
                                folds=folds)
        else:
            jmodel = JaxMultimodalCVAE(dims, hidden, z, c_dim, len(dims),
                                       variant=name, **extra)
            model = MultimodalCVAE(dims, hidden, z, c_dim, len(dims),
                                   variant=name, folds=folds, **extra)
    tree = numpy_tree(jmodel.init_params(jax.random.PRNGKey(seed)))
    params_from_jax(stack_params([tree] * folds), model)
    return jmodel, tree, model


def cohorts(dims, seed=0, sizes=SIZES, c_dim=C, extras=None):
    """Per fold: per-modality data, the covariate block every modality
    shares, and one per-sample extra ``extras`` names ({"fi"} or
    {"labels"})."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        data = [rng.standard_normal((n, d)).astype(np.float32) for d in dims]
        cov = rng.standard_normal((n, c_dim)).astype(np.float32)
        extra = {}
        for k in extras or ():
            extra[k] = (rng.integers(0, 2, n).astype(np.float32)[:, None]
                        if k == "labels"
                        else rng.standard_normal((n, 1)).astype(np.float32))
        out.append((data, cov, extra))
    return out


def port_batches(folds_data, batch=BATCH):
    extras = [e for _, _, e in folds_data]
    return stack_fold_batches(
        [d for d, _, _ in folds_data],
        [[c] * len(d) for d, c, _ in folds_data], batch,
        extras=extras if any(extras) else None)


def jax_sequential(trainer, tree, folds_data, extra_key=None):
    """The JAX sequential packed trainer on every fold from ``tree`` and
    PRNGKey(42), as the JAX CLIs run it: [(params, logs)] per fold."""
    out = []
    for data, cov, extra in folds_data:
        args = (tree, data, cov)
        if extra_key is not None:
            args += (extra[extra_key][:, 0],)
        params, logs = trainer.run(*args, jax.random.PRNGKey(42))
        out.append((numpy_tree(params), numpy_tree(logs)))
    return out


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def check_trajectory(model, logs, ref, param_tol=PARAM_TOL,
                     skip=lambda path: False, log_tols=None):
    """Every fold's logs (``log_tols`` {key: bound} where a term has its
    own) and trained parameters against the JAX runs'."""
    assert set(logs) == set(model.log_keys)
    for f, (ref_params, ref_logs) in enumerate(ref):
        for k in model.log_keys:
            assert np.isfinite(logs[k][f]).all(), k
            close(logs[k][f], ref_logs[k], err_msg=k,
                  **(log_tols or {}).get(k, LOG_TOL))
        got = params_to_jax(model, fold=f)
        got_leaves = jax.tree_util.tree_leaves_with_path(got)
        ref_leaves = jax.tree_util.tree_leaves_with_path(ref_params)
        assert len(got_leaves) == len(ref_leaves)
        for (path, a), (_, b) in zip(got_leaves, ref_leaves):
            name = jax.tree_util.keystr(path)
            assert np.isfinite(a).all(), name
            if not skip(name):
                close(a, b, err_msg=f"fold {f} {name}", **param_tol)


def bf16_draws(valid, epochs, rows, z_dim):
    """jax_draws with the noise drawn as JAX draws it in a bf16 forward
    (normal in bfloat16), widened to float32 exactly."""
    folds, nb = valid.shape
    eps = np.zeros((epochs * nb, folds, rows, z_dim), np.float32)
    for f in range(folds):
        k = jax.random.PRNGKey(42)
        for epoch in range(epochs):
            k, _ = jax.random.split(k)
            for step in range(nb):
                new_k, sub = jax.random.split(k)
                eps[epoch * nb + step, f] = np.asarray(jax.random.normal(
                    sub, (rows, z_dim), jnp.bfloat16).astype(jnp.float32))
                if valid[f, step]:
                    k = new_k
    return {"eps": eps}


# ---- routing ----------------------------------------------------------------

ROUTING = [(name, widths, precision) for name in REGISTRY_NAMES
           for widths in ("uniform", "mixed")
           for precision in ("fp32", "bf16")]
WIDTHS = {"uniform": [12, 12, 12], "mixed": [12, 20, 12]}


@pytest.mark.parametrize("name,widths,precision", ROUTING)
def test_routing_matches_jax(name, widths, precision):
    """packed_supported's decision and reason, and select_packed_trainer's
    layout name and tag, for every registry model, width pattern and
    precision."""
    dims = WIDTHS[widths]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jmodel = jax_build(name, dims, HIDDEN, 6, C, len(dims))
        model = build_model(name, dims, HIDDEN, 6, C, len(dims))
    jconfig = JaxConfig(combine="gpoe", precision=precision)
    config = TrainConfig(combine="gpoe", precision=precision)
    assert (packed.packed_supported(model, config)
            == jax_packed.packed_supported(jmodel, jconfig))
    _, layout, tag = grouped.select_packed_trainer(model)
    _, jlayout, jtag = jax_grouped.select_packed_trainer(jmodel, True)
    assert (layout, tag) == (jlayout, jtag)
    assert grouped.grouped_routing(model) == jax_grouped.grouped_routing(
        jmodel)


@pytest.mark.parametrize("change", [
    {"combine": "sum"}, {"shuffle": True}, {"precision": "fp16"}])
def test_refusals_match_jax(change):
    jmodel = jax_build("cVAE_multimodal", [12, 12], HIDDEN, 6, C, 2)
    model = build_model("cVAE_multimodal", [12, 12], HIDDEN, 6, C, 2)
    got = packed.packed_supported(model, TrainConfig(**change))
    assert got == jax_packed.packed_supported(jmodel, JaxConfig(**change))
    assert not got[0]


def test_the_end_to_end_model_is_refused_as_in_jax():
    from multi_modal_normative_modeling_tpu.models.endtoend import (
        EndToEndCVAE as JaxEndToEnd,
    )
    from multi_modal_normative_modeling_tpu_torch.models import EndToEndCVAE

    got = packed.packed_supported(EndToEndCVAE([8, 8], HIDDEN, 4, C, 2),
                                  TrainConfig())
    assert got == jax_packed.packed_supported(
        JaxEndToEnd([8, 8], HIDDEN, 4, C, 2), JaxConfig())


@pytest.mark.parametrize("layout", ["padded", "grouped", "dmvae"])
def test_state_dirnames_are_the_jax_names(layout):
    assert (grouped.packed_state_dirname(layout)
            == jax_grouped.packed_state_dirname(layout))


@pytest.mark.parametrize("layout", ["padded", "grouped", "dmvae"])
def test_stale_padded_state_notice_is_the_jax_one(layout, tmp_path, capsys):
    (tmp_path / "packed-state").mkdir()
    jax_grouped.notice_stale_padded_state(tmp_path, layout)
    want = capsys.readouterr().out
    grouped.notice_stale_padded_state(tmp_path, layout)
    assert capsys.readouterr().out == want
    assert bool(want) == (layout == "grouped")


# ---- the padded layout ------------------------------------------------------

@pytest.mark.parametrize("layout", ["padded", "grouped"])
def test_fold_batches_match_jax(layout):
    """make_packed_fold_batches / make_grouped_fold_batches: one fold's
    packed batches equal the JAX package's, leaf for leaf."""
    dims = [12, 20, 12]
    (data, cov, _), = cohorts(dims, sizes=(37,))
    jmodel = jax_build("cVAE_multimodal", dims, HIDDEN, 6, C, 3)
    model = build_model("cVAE_multimodal", dims, HIDDEN, 6, C, 3)
    if layout == "padded":
        port = packed.PackedMultiFoldTrainer(model, TrainConfig(), 37)
        jax_layout = jax_packed.PackedFoldTrainer(jmodel, JaxConfig(),
                                                  37).stacked
        got = packed.make_packed_fold_batches(port.layout, data, cov, BATCH)
        ref = jax_packed.make_packed_fold_batches(jax_layout, data, cov,
                                                  BATCH)
    else:
        port = grouped.GroupedMultiFoldTrainer(model, TrainConfig(), 37)
        jax_layout = jax_grouped.GroupedFoldTrainer(jmodel, JaxConfig(),
                                                    37).stacked
        got = grouped.make_grouped_fold_batches(port.layout, data, cov,
                                                BATCH)
        ref = jax_grouped.make_grouped_fold_batches(jax_layout, data, cov,
                                                    BATCH)
    got_leaves, got_def = jax.tree_util.tree_flatten(got)
    ref_leaves, ref_def = jax.tree_util.tree_flatten(ref)
    assert got_def == ref_def
    for a, b in zip(got_leaves, ref_leaves):
        np.testing.assert_array_equal(a, np.asarray(b))


# name -> (model, latent dim, combine, extra)
PADDED = {
    "cvae-gpoe": ("cVAE_multimodal", 5, "gpoe", {}),
    "mmjsd-per-modality-jsd": ("mmjsd", 5, "poe", {"jsd_on_fused": False}),
    "mvtcae-gpoe": ("mvtCAE", 5, "gpoe", {}),
    "nmmlp-moe": ("nmmlp", 5, "moe", {}),
}
UNIFORM = [12, 12, 12]


@pytest.mark.parametrize("case", PADDED)
def test_padded_trajectory_matches_jax_sequential(case):
    name, z, combine, extra = PADDED[case]
    jmodel, tree, model = make_jax_port(name, UNIFORM, z, extra=extra)
    data = cohorts(UNIFORM, seed=1)
    jconfig = JaxConfig(epochs=EPOCHS, batch_size=BATCH, combine=combine)
    ref = jax_sequential(jax_packed.PackedFoldTrainer(jmodel, jconfig, 37),
                         tree, data)

    config = TrainConfig(epochs=EPOCHS, batch_size=BATCH, combine=combine)
    cls, _, tag = grouped.select_packed_trainer(model)
    assert tag == "padded" and cls is packed.PackedMultiFoldTrainer
    batches = port_batches(data)
    assert batches["valid"].tolist() == [[True] * 3, [True, True, False]]
    logs = cls(model, config, 37).run(
        batches, **jax_draws(batches["valid"], EPOCHS, BATCH,
                             model.noise_dim))
    check_trajectory(model, logs, ref)


@pytest.mark.parametrize("dims", [UNIFORM, [12, 20, 12]],
                         ids=["padded", "grouped"])
def test_bf16_matches_jax_bf16(dims):
    """The bf16 forward with fp32 master weights against JAX's, on JAX's
    bf16 noise: every logged term within rtol 2e-2 (and the fp32 run's
    within rtol 2e-2 of it)."""
    jmodel, tree, model = make_jax_port("cVAE_multimodal", dims, 5)
    fp32 = make_jax_port("cVAE_multimodal", dims, 5)[2]
    data = cohorts(dims, seed=2)
    jconfig = JaxConfig(epochs=EPOCHS, batch_size=BATCH, combine="gpoe",
                        precision="bf16")
    jcls = (jax_grouped.GroupedFoldTrainer if dims != UNIFORM
            else jax_packed.PackedFoldTrainer)
    ref = jax_sequential(jcls(jmodel, jconfig, 37), tree, data)
    batches = port_batches(data)
    draws = bf16_draws(batches["valid"], EPOCHS, BATCH, 5)
    cls, _, _ = grouped.select_packed_trainer(model)
    logs = cls(model, TrainConfig(epochs=EPOCHS, batch_size=BATCH,
                                  combine="gpoe", precision="bf16"),
               37).run(batches, **draws)
    logs32 = cls(fp32, TrainConfig(epochs=EPOCHS, batch_size=BATCH,
                                   combine="gpoe"), 37).run(batches, **draws)
    for f, (_, ref_logs) in enumerate(ref):
        for k in model.log_keys:
            close(logs[k][f], ref_logs[k], rtol=2e-2, err_msg=k)
            close(logs[k][f], logs32[k][f], rtol=2e-2, err_msg=k)
    for leaf in params_to_jax(model)["enc"][0]["hidden"]:
        assert leaf["w"].dtype == np.float32   # fp32 master weights


def test_padded_entries_stay_zero_under_adam():
    """Mixed widths on the padded layout: the padded weight rows and
    columns hold exactly zero after a run (their gradients are zero, so
    MaskedAdam leaves them where they started)."""
    dims = [12, 20, 8]
    _, _, model = make_jax_port("cVAE_multimodal", dims, 5)
    trainer = packed.PackedMultiFoldTrainer(
        model, TrainConfig(epochs=3, batch_size=BATCH, combine="gpoe"), 37)
    session = trainer.session(port_batches(cohorts(dims, seed=3)))
    session.advance(3)
    tree = session.packed
    for m, d in enumerate(dims):
        assert torch.count_nonzero(
            tree["enc"]["layers"][0]["w"][:, m, d:20]) == 0
        dec = tree["dec"]
        for leaf in (dec["wm"][:, m, :, d:], dec["bm"][:, m, d:],
                     dec["lvo"][:, m, d:]):
            assert torch.count_nonzero(leaf) == 0
        assert torch.count_nonzero(session.adam.m) > 0
    before = params_to_jax(model)
    trainer.write_back(session)
    moved = jax.tree_util.tree_leaves(params_to_jax(model))
    assert any(not np.array_equal(a, b) for a, b in
               zip(moved, jax.tree_util.tree_leaves(before)))


# ---- the train CLI ----------------------------------------------------------

MODEL_DIR = "outputs/kfold_analysis/supervised_cvae"


def _cli_args(procedure, **extra):
    args = dict(
        dataset_resourse="ADNI", hz_para_list=[12, 12, 4],
        procedure=procedure, combine=procedure.split("-")[1], epochs=3,
        n_splits=2, oversample_percentage=1, model="cVAE_multimodal",
        single_modality=None, base_learning_rate=0.0001,
        max_learning_rate=0.005, training_class="nm",
        lr_schedule="constant", fold_parallel=False, precision="fp32",
        batch_size=13, packed_xla=True)
    return argparse.Namespace(**{**args, **extra})


def _jax_cli_init(model):
    jmodel = jax_build("cVAE_multimodal", model.input_dim_list,
                       model.hidden_dim, model.latent_dim, model.c_dim,
                       model.modalities)
    tree = numpy_tree(jmodel.init_params(jax.random.PRNGKey(42)))
    params_from_jax(stack_params([tree] * model.folds), model)


def _replay(valid, epochs, rows, z_dim):
    return jax_draws(valid, epochs, rows, z_dim)["eps"]


@pytest.mark.parametrize("procedure,layout", [
    ("SE-MoE", "packed"), ("UCA-gPoE", "width-grouped")])
def test_train_cli_packed_run_matches_the_jax_cli(procedure, layout,
                                                   tmp_path, capsys):
    """The JAX train CLI with --packed_xla (its sequential per-fold packed
    trainer) and the port's on the same cohort, init and noise: the same
    fold ids and checkpoint files, the parameters within the trajectory
    bound, the layout named as JAX names it."""
    make_synthetic_resource(tmp_path / "jax", "ADNI", n_hc=30,
                            n_disease={0: 11, 1: 10}, with_early_fusion=True)
    jax_train_cli.main(_cli_args(procedure), project_root=tmp_path / "jax")
    jax_out = capsys.readouterr().out
    assert f"train model ({layout} modalities)" in jax_out
    shutil.copytree(tmp_path / "jax" / "data", tmp_path / "port" / "data")
    port_train_cli.main(_cli_args(procedure, device="cpu"),
                        project_root=tmp_path / "port", init_fn=_jax_cli_init,
                        eps_fn=_replay)
    out = capsys.readouterr().out
    assert (f"train model (all folds fold-parallel, {layout} modalities)"
            in out)

    def files(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                      if p.is_file() and "outputs" in p.parts
                      and p.suffix != ".png" and p.name != "run_log.jsonl")

    assert files(tmp_path / "port") == files(tmp_path / "jax")
    for f in range(2):
        for kind in ("train", "test"):
            rel = f"outputs/kfold_analysis/{kind}_ids_{f:03d}.csv"
            assert ((tmp_path / "port" / rel).read_bytes()
                    == (tmp_path / "jax" / rel).read_bytes())
        ref, ref_config = read_flax_checkpoint(tmp_path / "jax" / MODEL_DIR
                                               / f"{f:03d}")
        got, config = read_flax_checkpoint(tmp_path / "port" / MODEL_DIR
                                           / f"{f:03d}")
        assert config == ref_config
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(ref)):
            close(a, b, **PARAM_TOL)


def _port_cli(tmp_path, cohort, **extra):
    root = tmp_path / "_".join(f"{k}{v}" for k, v in extra.items())
    shutil.copytree(cohort / "data", root / "data")
    args = _cli_args("UCA-gPoE", device="cpu", **extra)
    port_train_cli.main(args, project_root=root, init_fn=_jax_cli_init)
    return root


def test_train_cli_decisions_print_the_jax_texts(tmp_path, capsys):
    """--fused_decoder beside an active packed layout, a non-cvae model in
    bf16, and bf16 without --packed_xla (the per-modality trainer trains in
    bf16)."""
    make_synthetic_resource(tmp_path / "c", "ADNI", n_hc=20,
                            n_disease={0: 6, 1: 6}, with_early_fusion=True)
    root = _port_cli(tmp_path, tmp_path / "c", fused_decoder=True)
    out = capsys.readouterr().out
    assert ("fused decoder unavailable (mutually exclusive with "
            "--packed_xla); using the plain loss") in out
    assert (root / MODEL_DIR / "001" / "cVAE_model.ckpt").exists()
    bf16 = _port_cli(tmp_path, tmp_path / "c", precision="bf16")
    assert "width-grouped modalities" in capsys.readouterr().out
    assert (bf16 / MODEL_DIR / "001" / "cVAE_model.ckpt").exists()
    # bf16 without --packed_xla, and for a model the packed bf16 path does
    # not take, trains the per-modality layout in bf16 (as the JAX CLI)
    for name, extra, said in (
            ("per_modality", {"packed_xla": False, "precision": "bf16"},
             "train model (all folds fold-parallel)"),
            ("mmjsd", {"model": "mmJSD", "precision": "bf16"},
             "packed XLA path unavailable (bf16 packed path is cvae-only")):
        args = _cli_args("UCA-gPoE", device="cpu", epochs=1)
        vars(args).update(extra)
        shutil.copytree(tmp_path / "c" / "data", tmp_path / name / "data")
        port_train_cli.main(args, project_root=tmp_path / name)
        assert said in capsys.readouterr().out
        assert (tmp_path / name / MODEL_DIR / "001"
                / "cVAE_model.ckpt").exists()
