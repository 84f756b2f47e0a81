"""The packed layouts of the DMVAE family, the end-to-end model and the
regression, resume on every packed layout, and ``--packed_xla`` on the
variant CLIs and the supervised sweep, on the CPU.

Each layout's packed tree is the JAX ``pack_params``' leaf for leaf; its
forward and loss are held at rtol 1e-5 and its gradients at rtol 2e-4 on
the noise (and dropout keep masks) JAX draws from the same key; its
trajectory (every fold at once) is held to the JAX package's sequential
per-fold trainer at logs rtol 2e-4 (the regression term rtol 2e-3, as
tests/test_packed_regression.py holds it) and params rtol 5e-3 / atol 5e-5,
atol 5e-4 for the end-to-end model and the regression (their JAX tests'
bound). A run killed and resumed on any layout is byte-equal to the
straight run. The CLIs' packed runs write the files their per-modality runs
write (which tests/test_torch_variant_cli.py and
tests/test_torch_sweep_cli.py hold to the JAX CLIs'), and, drawing the
same noise, the same parameters within the trajectory bound.
"""
import json
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_normative_modeling_tpu.models.endtoend import (
    EndToEndCVAE as JaxEndToEnd,
)
from multi_modal_normative_modeling_tpu.models.grouped_dmvae import (
    GroupedDMVAE as JaxGroupedDMVAE,
)
from multi_modal_normative_modeling_tpu.models.grouped_endtoend import (
    GroupedEndToEnd as JaxGroupedEndToEnd,
)
from multi_modal_normative_modeling_tpu.models.grouped_regression import (
    GroupedRegressionCVAE as JaxGroupedRegression,
)
from multi_modal_normative_modeling_tpu.models.regression import (
    RegressionCVAE as JaxRegression,
)
from multi_modal_normative_modeling_tpu.train import TrainConfig as JaxConfig
from multi_modal_normative_modeling_tpu.train import (
    grouped_dmvae as jax_grouped_dmvae,
    packed_endtoend as jax_packed_endtoend,
    packed_regression as jax_packed_regression,
)
from multi_modal_normative_modeling_tpu_torch.cli import (
    common,
    nmmlp,
    nmpmcont,
    regression,
    sweep_supervised,
)
from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
    make_synthetic_resource,
)
from multi_modal_normative_modeling_tpu_torch.interop import (
    packed_from_jax,
    params_to_jax,
    read_flax_checkpoint,
)
from multi_modal_normative_modeling_tpu_torch.models import (
    EndToEndCVAE,
    RegressionCVAE,
)
from multi_modal_normative_modeling_tpu_torch.models.grouped_dmvae import (
    GroupedDMVAE,
)
from multi_modal_normative_modeling_tpu_torch.models.grouped_endtoend import (
    GroupedEndToEnd,
)
from multi_modal_normative_modeling_tpu_torch.models import (
    grouped_regression,
)
from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
from multi_modal_normative_modeling_tpu_torch.train import grouped
from multi_modal_normative_modeling_tpu_torch.train.checkpoints import to_bytes
from multi_modal_normative_modeling_tpu_torch.train.packed import (
    PackedMultiFoldTrainer,
)
from multi_modal_normative_modeling_tpu_torch.train.packed_endtoend import (
    GroupedEndToEndTrainer,
    endtoend_state_dirname,
)
from multi_modal_normative_modeling_tpu_torch.train.packed_regression import (
    GroupedRegressionTrainer,
    regression_state_dirname,
)
from tests.test_torch_endtoend import _sign_noise_leaf, jax_draws
from tests.test_torch_packed import (
    BATCH,
    EPOCHS,
    HIDDEN,
    C,
    check_trajectory,
    close,
    cohorts,
    jax_sequential,
    make_jax_port,
    numpy_tree,
    port_batches,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

DIMS = [16, 24, 16, 8]
B, FOLDS = 9, 2
TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)
LAYERS = (8, 6)
MARGIN, WCON = 1.0, 0.5


def _inputs(seed=1, c_dim=C):
    rng = np.random.default_rng(seed)
    xes = [rng.standard_normal((FOLDS, B, d)).astype(np.float32)
           for d in DIMS]
    c = rng.standard_normal((FOLDS, B, c_dim)).astype(np.float32)
    mask = np.ones((FOLDS, B), np.float32)
    mask[1, B - 4:] = 0.0
    return xes, c, mask


def _leaves(packed):
    leaves, treedef = jax.tree_util.tree_flatten(packed)
    leaves = [t.requires_grad_() for t in leaves]
    return leaves, jax.tree_util.tree_unflatten(treedef, leaves)


def _same_leaves(got, ref):
    got_leaves, got_def = jax.tree_util.tree_flatten(got)
    ref_leaves, ref_def = jax.tree_util.tree_flatten(ref)
    assert got_def == ref_def
    for a, b in zip(got_leaves, ref_leaves):
        np.testing.assert_array_equal(a, b)


def _fold(tree, f):
    return jax.tree_util.tree_map(lambda t: t[f].detach().numpy(), tree)


# ---- the split-latent DMVAE family ------------------------------------------

# name -> (registry name, latent dim): a real shared code, or an empty one
DMVAE = {"DMVAE": ("DMVAE", 9), "WeightedDMVAE-empty-shared":
         ("WeightedDMVAE", 3), "mmVAEPlus": ("mmVAEPlus", 9)}


@pytest.mark.parametrize("case", DMVAE)
def test_dmvae_layout_matches_jax(case):
    name, z = DMVAE[case]
    jmodel, tree, model = make_jax_port(name, DIMS, z, folds=FOLDS)
    variant = model.variant
    layout = GroupedDMVAE(DIMS, HIDDEN, z, C, len(DIMS), variant)
    jlayout = JaxGroupedDMVAE(DIMS, HIDDEN, z, C, len(DIMS), variant)
    trees = [tree, numpy_tree(jmodel.init_params(jax.random.PRNGKey(1)))]
    packed = packed_from_jax(trees, layout)
    xes, _, mask = _inputs()
    keys = [jax.random.PRNGKey(3 + f) for f in range(FOLDS)]
    noise = model.noise_dim
    eps = np.stack([np.asarray(jax.random.normal(k, (B, noise)))
                    for k in keys])
    leaves, packed = _leaves(packed)
    x_groups = layout.pack_inputs(xes)
    fwd = layout.forward(packed, x_groups, torch.from_numpy(eps))
    loss = layout.loss(packed, x_groups, fwd, torch.from_numpy(mask))
    grads = torch.autograd.grad(loss["total"].sum(), leaves)

    def run(p, jx, jmask, key):
        out = jlayout.forward(p, jx, key)
        return jlayout.loss(p, jx, out, jmask), out

    run_jit = jax.jit(run)
    grad_jit = jax.jit(jax.grad(lambda *a: run(*a)[0]["total"]))
    for f in range(FOLDS):
        jpacked = jlayout.pack_params(trees[f])
        _same_leaves(_fold(packed, f), numpy_tree(jpacked))
        _same_leaves(numpy_tree(jlayout.unpack_params(_fold(packed, f))),
                     trees[f])
        args = (tuple(jnp.asarray(g) for g in
                      jlayout.pack_inputs([x[f] for x in xes])),
                jnp.asarray(mask[f]), keys[f])
        ref_loss, ref_fwd = run_jit(jpacked, *args)
        for k in ("total", "kl", "ll"):
            close(loss[k][f].item(), float(ref_loss[k]), err_msg=k, **TOL)
        for gi in range(len(layout.groups)):
            close(fwd["recon_means"][gi][f].detach(),
                  ref_fwd["recon_means"][gi], rtol=1e-4, atol=1e-5)
        for a, b in zip(grads, jax.tree_util.tree_leaves(
                grad_jit(jpacked, *args))):
            close(a[f], b, **GRAD_TOL)
    for a, b in zip(layout.pred_recon(packed, x_groups, torch.from_numpy(eps)),
                    fwd["recon_means"]):
        assert torch.equal(a, b)
    dev = layout.reconstruction_deviation(x_groups, fwd["recon_means"])
    assert dev.shape == (FOLDS, len(DIMS), B)


@pytest.mark.parametrize("case", DMVAE)
def test_dmvae_trajectory_matches_jax_sequential(case):
    name, z = DMVAE[case]
    jmodel, tree, model = make_jax_port(name, DIMS, z)
    data = cohorts(DIMS, seed=6)
    jconfig = JaxConfig(epochs=EPOCHS, batch_size=BATCH, combine="poe")
    ref = jax_sequential(
        jax_grouped_dmvae.GroupedDMVAEFoldTrainer(jmodel, jconfig, 37),
        tree, data)
    cls, layout, tag = grouped.select_packed_trainer(model)
    assert (layout, tag) == ("split-latent grouped", "dmvae")
    batches = port_batches(data)
    logs = cls(model, TrainConfig(epochs=EPOCHS, batch_size=BATCH,
                                  combine="poe"), 37).run(
        batches, **jax_draws(batches["valid"], EPOCHS, BATCH,
                             model.noise_dim))
    check_trajectory(model, logs, ref)


# ---- the end-to-end model's dual banks --------------------------------------

def _e2e_draws(key, rows, z):
    """One fold's eps and keep masks of one JAX end-to-end forward."""
    _, z_key, drop_key = jax.random.split(key, 3)
    eps = np.asarray(jax.random.normal(z_key, (rows, z)))
    keeps = []
    for w in LAYERS:
        drop_key, block = jax.random.split(drop_key)
        keeps.append(np.asarray(jax.random.bernoulli(block, 0.5, (rows, w))))
    return eps, keeps


def _e2e_pair(seed=0):
    extra = {"classifier_layers": LAYERS}
    return make_jax_port(None, DIMS, 5, extra=extra, seed=seed,
                         jax_cls=JaxEndToEnd, port_cls=EndToEndCVAE)


def test_endtoend_layout_matches_jax():
    jmodel, tree, model = _e2e_pair()
    layout = GroupedEndToEnd(DIMS, HIDDEN, 5, C, len(DIMS))
    jlayout = JaxGroupedEndToEnd(DIMS, HIDDEN, 5, C, len(DIMS),
                                 classifier_layers=LAYERS)
    packed = packed_from_jax([tree] * FOLDS, layout)
    jpacked = jlayout.pack_params(tree)
    for f in range(FOLDS):
        _same_leaves(_fold(packed, f), numpy_tree(
            {k: jpacked[k] for k in ("enc", "dec")}))
    back = numpy_tree(jlayout.unpack_params(
        {**_fold(packed, 0), "classifier": tree["classifier"],
         "bn_state": tree["bn_state"]}))
    _same_leaves(back, tree)

    xes, c, mask = _inputs()
    labels = np.random.default_rng(2).integers(0, 2, (FOLDS, B))
    keys = [jax.random.PRNGKey(5 + f) for f in range(FOLDS)]
    draws = [_e2e_draws(k, B, 5) for k in keys]
    eps = torch.from_numpy(np.stack([d[0] for d in draws]))
    keeps = [torch.from_numpy(np.stack([d[1][i] for d in draws]))
             for i in range(len(LAYERS))]
    leaves, packed = _leaves(packed)
    x_groups = layout.pack_inputs(xes)
    tc, tm = torch.from_numpy(c), torch.from_numpy(mask)
    fwd = layout.forward(packed, x_groups, tc, eps, model.classifier,
                         train=True, mask=tm, keep=keeps)
    loss = layout.loss(packed, x_groups, fwd, torch.from_numpy(labels),
                       margin=MARGIN, weight_contrastive=WCON, mask=tm)
    grads = torch.autograd.grad(loss["total_loss"].sum(), leaves)

    def run(p, jx, jc, jlabels, jmask, key):
        out = jlayout.forward(p, jx, jc, key, train=True, mask=jmask)
        return jlayout.loss(p, jx, out, jlabels, margin=MARGIN,
                            weight_contrastive=WCON, mask=jmask), out

    run_jit = jax.jit(run)
    grad_jit = jax.jit(jax.grad(lambda *a: run(*a)[0]["total_loss"]))
    for f in range(FOLDS):
        args = (tuple(jnp.asarray(g) for g in
                      jlayout.pack_inputs([x[f] for x in xes])),
                jnp.asarray(c[f]), jnp.asarray(labels[f]),
                jnp.asarray(mask[f]), keys[f])
        ref_loss, ref_fwd = run_jit(jpacked, *args)
        assert set(loss) == set(ref_loss)
        for k in ref_loss:
            close(loss[k][f].item(), float(ref_loss[k]), err_msg=k, **TOL)
        close(fwd["logits"][f].detach(), ref_fwd["logits"], rtol=1e-4,
              atol=1e-5)
        ref_grads = grad_jit(jpacked, *args)
        for a, b in zip(grads, jax.tree_util.tree_leaves(
                {k: ref_grads[k] for k in ("enc", "dec")})):
            close(a[f], b, **GRAD_TOL)
    logits = layout.predict(packed, x_groups, tc, model.classifier)
    ref_logits = model.predict_reference(
        [torch.from_numpy(x) for x in xes], [tc] * len(DIMS))
    close(logits, ref_logits, rtol=1e-5, atol=1e-6)


def test_endtoend_trajectory_matches_jax_sequential():
    """The dual-bank trainer with labels as extras, dropout keep masks and
    the BatchNorm state written back for the valid folds only, against
    JAX's sequential GroupedEndToEndTrainer (the sign-noise leaves of
    tests/test_torch_endtoend.py aside)."""
    jmodel, tree, model = _e2e_pair(seed=2)
    data = cohorts(DIMS, seed=7, extras=("labels",))
    jconfig = JaxConfig(epochs=EPOCHS, batch_size=BATCH, combine="poe")
    ref = jax_sequential(jax_packed_endtoend.GroupedEndToEndTrainer(
        jmodel, jconfig, 37, MARGIN, WCON), tree, data, extra_key="labels")
    batches = port_batches(data)
    before = params_to_jax(model)["bn_state"][0]["var"].copy()
    trainer = GroupedEndToEndTrainer(
        model, TrainConfig(epochs=EPOCHS, batch_size=BATCH, combine="poe"),
        37, MARGIN, WCON)
    logs = trainer.run(batches, **jax_draws(
        batches["valid"], EPOCHS, BATCH, 5, model.keep_widths))
    check_trajectory(model, logs, ref,
                     param_tol=dict(rtol=5e-3, atol=5e-4),
                     skip=_sign_noise_leaf)
    after = params_to_jax(model)["bn_state"][0]["var"]
    assert not np.array_equal(after, before)
    assert trainer.loss_meta["margin"] == str(MARGIN)


# ---- the regression ---------------------------------------------------------

def _regression_pair(seed=0):
    return make_jax_port(None, DIMS, 5, c_dim=2, seed=seed,
                         jax_cls=JaxRegression, port_cls=RegressionCVAE)


def test_regression_layout_matches_jax():
    jmodel, tree, model = _regression_pair()
    layout = grouped_regression.GroupedRegressionCVAE(DIMS, HIDDEN, 5, 2,
                                                      len(DIMS))
    jlayout = JaxGroupedRegression(DIMS, HIDDEN, 5, 2, len(DIMS))
    packed = packed_from_jax([tree] * FOLDS, layout)
    jpacked = jlayout.pack_params(tree)
    _same_leaves(_fold(packed, 1), numpy_tree(
        {k: jpacked[k] for k in ("enc", "dec", "alpha")}))
    xes, c, mask = _inputs(c_dim=2)
    fi = np.random.default_rng(4).standard_normal((FOLDS, B)).astype(
        np.float32)
    keys = [jax.random.PRNGKey(9 + f) for f in range(FOLDS)]
    eps = np.stack([np.asarray(jax.random.normal(k, (B, 5))) for k in keys])
    leaves, packed = _leaves(packed)
    x_groups = layout.pack_inputs(xes)
    fwd = layout.forward(packed, x_groups, torch.from_numpy(c), "gpoe",
                         torch.from_numpy(eps), model.regress)
    loss = layout.loss(packed, x_groups, fwd, torch.from_numpy(fi),
                       mask=torch.from_numpy(mask))
    head = [p for layer in model.regressor for p in (layer.weight,
                                                     layer.bias)]
    grads = torch.autograd.grad(loss["total"].sum(), leaves + head)

    def run(p, jx, jc, jfi, jmask, key):
        out = jlayout.forward(p, jx, jc, key, "gpoe")
        return jlayout.loss(p, jx, out, jfi, mask=jmask), out

    run_jit = jax.jit(run)
    grad_jit = jax.jit(jax.grad(lambda *a: run(*a)[0]["total"]))
    for f in range(FOLDS):
        args = (tuple(jnp.asarray(g) for g in
                      jlayout.pack_inputs([x[f] for x in xes])),
                jnp.asarray(c[f]), jnp.asarray(fi[f]), jnp.asarray(mask[f]),
                keys[f])
        ref_loss, ref_fwd = run_jit(jpacked, *args)
        assert set(loss) == set(ref_loss)
        for k in ref_loss:
            close(loss[k][f].item(), float(ref_loss[k]), err_msg=k, **TOL)
        close(fwd["fi_pred"][f].detach(), ref_fwd["fi_pred"], rtol=1e-4,
              atol=1e-5)
        ref_grads = grad_jit(jpacked, *args)
        packed_ref = jax.tree_util.tree_leaves(
            {k: ref_grads[k] for k in ("enc", "dec", "alpha")})
        head_ref = [leaf for layer in ref_grads["regressor"]
                    for leaf in (np.asarray(layer["w"]).T, layer["b"])]
        for a, b in zip(grads, packed_ref + head_ref):
            close(a[f], b, **GRAD_TOL)
    assert torch.equal(layout.pred_fi(packed, x_groups, torch.from_numpy(c),
                                      "gpoe", torch.from_numpy(eps),
                                      model.regress), fwd["fi_pred"])


def test_shuffled_regression_trajectory_matches_jax_sequential():
    """The per-epoch shuffle on the grouped layout (sample axis 3): every
    fold permutes its own grid with JAX's permutation (replayed), as the
    per-modality shuffled regression does."""
    jmodel, tree, model = _regression_pair(seed=3)
    data = cohorts(DIMS, seed=8, c_dim=2, extras=("fi",))
    jconfig = JaxConfig(epochs=EPOCHS, batch_size=BATCH, combine="gpoe",
                        shuffle=True)
    ref = jax_sequential(jax_packed_regression.GroupedRegressionTrainer(
        jmodel, jconfig, 37), tree, data, extra_key="fi")
    batches = port_batches(data)
    logs = GroupedRegressionTrainer(
        model, TrainConfig(epochs=EPOCHS, batch_size=BATCH, combine="gpoe",
                           shuffle=True), 37).run(
        batches, **jax_draws(batches["valid"], EPOCHS, BATCH, 5,
                             shuffle=True))
    check_trajectory(model, logs, ref, param_tol=dict(rtol=5e-3, atol=5e-4),
                     log_tols={"regression": dict(rtol=2e-3, atol=1e-6)})


# ---- resume, on every layout ------------------------------------------------

def _layouts():
    """layout -> (fresh port model, trainer factory, batches, state dir)."""
    mixed = cohorts(DIMS, seed=9)
    uniform = cohorts([12, 12, 12], seed=9)

    def skeleton(dims, name, z):
        return lambda: make_jax_port(name, dims, z)[2]

    return {
        "padded": (skeleton([12, 12, 12], "mvtCAE", 5),
                   lambda m, cfg: PackedMultiFoldTrainer(m, cfg, 37),
                   port_batches(uniform), "packed-state"),
        "grouped": (skeleton(DIMS, "cVAE_multimodal", 5),
                    lambda m, cfg: grouped.GroupedMultiFoldTrainer(m, cfg, 37),
                    port_batches(mixed), "grouped-state"),
        "dmvae": (skeleton(DIMS, "DMVAE", 9),
                  lambda m, cfg: grouped.select_packed_trainer(m)[0](
                      m, cfg, 37),
                  port_batches(mixed), "grouped-dmvae-state"),
        "endtoend": (lambda: _e2e_pair()[2],
                     lambda m, cfg: GroupedEndToEndTrainer(m, cfg, 37,
                                                           MARGIN, WCON),
                     port_batches(cohorts(DIMS, seed=9, extras=("labels",))),
                     endtoend_state_dirname()),
        "regression": (lambda: _regression_pair()[2],
                       lambda m, cfg: GroupedRegressionTrainer(m, cfg, 37),
                       port_batches(cohorts(DIMS, seed=9, c_dim=2,
                                            extras=("fi",))),
                       regression_state_dirname()),
    }


@pytest.mark.parametrize("layout", ["padded", "grouped", "dmvae", "endtoend",
                                    "regression"])
def test_resume_is_byte_equal_to_the_straight_run(layout, tmp_path):
    new_model, new_trainer, batches, dirname = _layouts()[layout]
    shuffle = layout == "regression"

    def config(epochs):
        return TrainConfig(epochs=epochs, batch_size=BATCH, combine="gpoe",
                           shuffle=shuffle)

    straight = new_model()
    logs = new_trainer(straight, config(4)).run(batches)
    state = tmp_path / dirname
    killed = new_model()
    new_trainer(killed, config(2)).run_resumable(batches, state, 1)
    assert json.loads((state / "train_state.json").read_text()) == {
        "epoch": 2}
    resumed = new_model()
    trainer = new_trainer(resumed, config(4))
    got = trainer.run_resumable(batches, state, 1, resume=True)
    assert trainer.resumed_from == 2
    assert to_bytes(params_to_jax(resumed)) == to_bytes(
        params_to_jax(straight))
    for k in logs:
        np.testing.assert_array_equal(got[k], logs[k])


def test_a_state_of_another_layout_is_refused(tmp_path):
    """A state dir holding another layout's state (the padded layout's,
    copied into the grouped layout's dir) is not continued."""
    layouts = _layouts()
    new_model, new_trainer, batches, _ = layouts["padded"]
    cfg = TrainConfig(epochs=1, batch_size=BATCH, combine="gpoe")
    new_trainer(new_model(), cfg).run_resumable(batches, tmp_path / "a", 1)
    shutil.copytree(tmp_path / "a", tmp_path / "grouped-state")
    new_model, new_trainer, batches, _ = layouts["grouped"]
    with pytest.raises(ValueError, match="refusing to resume"):
        new_trainer(new_model(), cfg).run_resumable(
            batches, tmp_path / "grouped-state", 1, resume=True)


# ---- the CLIs ---------------------------------------------------------------

COMMON = ["-R", "ADNI", "-E", "2", "-K", "2", "-H", "16", "16", "4",
          "--device", "cpu"]
CLI_FLAGS = {
    "nmpmcont": COMMON + ["-P", "SE-MoE", "-Layers", "16", "8"],
    "nmmlp": ["all"] + COMMON + ["-P", "UCA-gPoE"],
    "regression": COMMON + ["-P", "UCA-gPoE", "--batch_size", "25"],
}
MODEL_DIR = "outputs/kfold_analysis/supervised_cvae"


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("packed_cli_data")
    make_synthetic_resource(root, "ADNI", n_hc=30, n_disease={0: 11, 1: 10},
                            with_fi=True, with_early_fusion=True)
    return root


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file() and "data" not in p.parts
                  and "state" not in str(p.parent.name))


def _run_cli(cli, cohort, root, extra=()):
    shutil.copytree(cohort / "data", root / "data")
    module = {"nmpmcont": nmpmcont, "nmmlp": nmmlp,
              "regression": regression}[cli]
    args = module.build_parser().parse_args(CLI_FLAGS[cli] + list(extra))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if cli == "nmpmcont":
            common.apply_post_parse_defaults(args, default_procedure="SE-MoE")
            module.main(args, root)
        elif cli == "nmmlp":
            module.main(args, root)
        else:
            module.train_and_test(args, root)


@pytest.mark.parametrize("cli,layout", [
    ("nmpmcont", "packed dual-bank endtoend"), ("nmmlp", "width-grouped"),
    ("regression", "width-grouped regression")])
def test_variant_cli_packed_run_writes_the_per_modality_files(
        cli, layout, cohort, tmp_path, capsys):
    """The CLI's --packed_xla run (every fold drawing the per-modality
    run's noise from its seeded generator) writes the files of its
    per-modality run, with parameters within the trajectory bound, and
    keeps its train state in the JAX package's dir for the layout."""
    _run_cli(cli, cohort, tmp_path / "plain")
    capsys.readouterr()
    _run_cli(cli, cohort, tmp_path / "packed",
             ["--packed_xla", "--checkpoint_every", "2"])
    out = capsys.readouterr().out
    assert f"train model (all folds fold-parallel, {layout} modalities)" in out
    assert _files(tmp_path / "packed") == _files(tmp_path / "plain")
    state = {"nmpmcont": f"{MODEL_DIR}/grouped-e2e-state",
             "nmmlp": f"{MODEL_DIR}/grouped-state",
             "regression": "regression_outputs/grouped-reg-state"}[cli]
    assert (tmp_path / "packed" / state / "train_state.ckpt").exists()
    if cli == "regression":
        for f in range(2):
            close(np.load(tmp_path / "packed" / "regression_outputs"
                          / f"fold_{f}_pred.npy"),
                  np.load(tmp_path / "plain" / "regression_outputs"
                          / f"fold_{f}_pred.npy"), rtol=5e-3, atol=5e-4)
        return
    for f in range(2):
        got, config = read_flax_checkpoint(tmp_path / "packed" / MODEL_DIR
                                           / f"{f:03d}")
        ref, ref_config = read_flax_checkpoint(tmp_path / "plain" / MODEL_DIR
                                               / f"{f:03d}")
        assert config == ref_config
        for path, a in jax.tree_util.tree_leaves_with_path(got):
            name = jax.tree_util.keystr(path)
            b = ref
            for p in path:
                b = b[p.key if hasattr(p, "key") else p.idx]
            if not _sign_noise_leaf(name):
                close(a, b, rtol=5e-3, atol=5e-4, err_msg=name)


def test_sweep_packed_run_matches_its_per_modality_run(tmp_path, capsys):
    """sweep_supervised --packed_xla: every grid point on the packed layout
    (the batches packed once per procedure) gives the per-modality grid's
    records and files."""
    make_synthetic_resource(tmp_path / "plain", "ADHD", n_hc=30,
                            n_disease={0: 12, 2: 12})
    shutil.copytree(tmp_path / "plain" / "data", tmp_path / "packed" / "data")
    argv = ["-R", "ADHD", "-K", "2", "--procedures", "SE-gPoE",
            "--hz_grid", "8 8 4", "--epochs_list", "1", "2",
            "--device", "cpu"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = sweep_supervised.run(argv, project_root=tmp_path / "plain")
        capsys.readouterr()
        got = sweep_supervised.run(argv + ["--packed_xla"],
                                   project_root=tmp_path / "packed")
    assert ("sweep training runs on the packed-modality layout "
            "(--packed_xla)") in capsys.readouterr().out
    assert _files(tmp_path / "packed") == _files(tmp_path / "plain")
    assert len(got) == len(ref) == 2
    for a, b in zip(got, ref):
        assert {k: v for k, v in a.items() if k != "stats"} == {
            k: v for k, v in b.items() if k != "stats"}
        for k in b["stats"]:
            close(a["stats"][k], b["stats"][k], rtol=5e-3, atol=5e-3)
