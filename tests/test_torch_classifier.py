"""The classifier baseline of the port against the JAX package's, on the
CPU.

The JAX ``init_params`` list goes into the port's stacked ``MLPClassifier``
through ``interop.classifier_from_jax``; with dropout the JAX Bernoulli
masks of ``train_classifier``'s key chain (``host_prng_key(42)``, split per
epoch, then per hidden layer) are replayed through ``mask_fn``.

Bounds: the forward rtol 1e-5 / atol 1e-6. The strict parity runs in fp64
(the JAX classifier with its float32 constants widened, a test-side
namespace): a 300-epoch run on the JAX CLI test's cohort
(tests/test_variants.py:117), early stopping and the grid against JAX's
grid, every history value and every leaf within 1e-9 relative. In fp32 the
two packages' products sum in different orders, and Adam turns a gradient
whose sign is rounding noise into a step of about lr: on this cohort at lr
1e-4 the runs agree at the bounds below for 150 epochs (losses rtol 1e-4,
best parameters rtol 5e-3 / atol 5e-5, the JAX sweep test's), and by epoch
300 the losses are 1.1e-4 apart and 2% of the leaves up to 7.3e-4, so the
300-epoch fp32 run (and the CLI's) is held at the JAX sweep test's loss
bound (rtol 2e-3), the learning-rate history equal, and the leaves within
rtol 5e-3 / atol 1e-3 (ten steps of lr). A grid point against its own run
(the same code) is held at the JAX sweep test's bounds
(tests/test_sweep.py:147-180). The split is index for index
scikit-learn's.
"""
import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.model_selection import train_test_split as sk_split

from multi_modal_normative_modeling_tpu.cli import (
    classifier_baseline as jax_cli,
)
from multi_modal_normative_modeling_tpu.cli.common import host_prng_key
from multi_modal_normative_modeling_tpu.data.synthetic import (
    make_synthetic_resource,
)
from multi_modal_normative_modeling_tpu.models import classifier as jc
from multi_modal_normative_modeling_tpu.train.checkpoints import (
    load_checkpoint as jax_load_checkpoint,
)
from multi_modal_normative_modeling_tpu_torch.cli import classifier_baseline
from multi_modal_normative_modeling_tpu_torch.data.splits import (
    stratified_split_indices,
    train_test_split,
)
from multi_modal_normative_modeling_tpu_torch.interop import (
    classifier_from_jax,
    classifier_to_jax,
    read_flax_checkpoint,
)
from multi_modal_normative_modeling_tpu_torch.models import classifier as pc
from tests.test_torch_threads import one_torch_thread  # noqa: F401

HIDDEN = [32, 16]
EPOCHS = 300
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_TOL = dict(rtol=1e-4, atol=0.0)
PARAM_TOL = dict(rtol=5e-3, atol=5e-5)
GRID_VAL_TOL = dict(rtol=2e-3, atol=0.0)
FP64_TOL = dict(rtol=1e-9, atol=0.0)
DRIFT_TOL = dict(rtol=5e-3, atol=1e-3)   # fp32 leaves after 300 epochs
METRICS = ["Accuracy", "Sensitivity (Recall for class 1)",
           "Specificity (Recall for class 0)", "F1-Score", "AUROC"]


# ------------------------------------------------------------- the split
SPLIT_CASES = [
    (200, (0.5, 0.5), 0.2, 42), (180, (0.5, 0.5), 0.1, 42),
    (101, (0.7, 0.3), 0.2, 0), (57, (0.8, 0.2), 0.33, 7),
    (64, (0.5, 0.3, 0.2), 0.25, 3), (333, (0.6, 0.4), 0.1, 12345),
    (40, (0.5, 0.5), 9, 1), (97, (0.9, 0.1), 0.2, 99),
    (250, (0.2, 0.3, 0.5), 0.5, 2), (12, (0.5, 0.5), 0.5, 5),
    (600, (0.5, 0.25, 0.25), 0.2, 42), (144, (0.5, 0.5), 0.1, 2024),
]


@pytest.mark.parametrize("n,ratio,test_size,seed", SPLIT_CASES)
def test_split_equals_sklearn(n, ratio, test_size, seed):
    rng = np.random.default_rng(n)
    y = rng.choice(len(ratio), size=n, p=ratio)
    x = rng.normal(size=(n, 3))
    want = sk_split(x, y, test_size=test_size, random_state=seed,
                    stratify=y)
    got = train_test_split(x, y, test_size=test_size, random_state=seed,
                           stratify=y)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_split_refusals_equal_sklearn():
    y = np.array([0, 0, 0, 1])
    for bad in (dict(test_size=0.5), dict(test_size=1.5)):
        with pytest.raises(ValueError):
            sk_split(y, test_size=bad["test_size"], random_state=0,
                     stratify=y)
        with pytest.raises(ValueError):
            stratified_split_indices(y, bad["test_size"], 0)


def test_cli_splits_equal_jax(cohort):
    """prepare_splits (72/8/20) row for row against the JAX CLI's."""
    x, y = jax_cli.load_data(*cohort)
    for a, b in zip(classifier_baseline.prepare_splits(x, y),
                    jax_cli.prepare_splits(x, y)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ the cohort
@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("classifier_cohort")
    make_synthetic_resource(root, "ADHD", n_hc=100, n_disease={0: 100},
                            effect=1.2)
    return (str(root / "data" / "ADHD" / "fMRI.csv"),
            str(root / "data" / "ADHD" / "y.csv"))


@pytest.fixture(scope="module")
def splits(cohort):
    return jax_cli.prepare_splits(*jax_cli.load_data(*cohort))


def pair(d, hidden, dropout=0.0, dtype=torch.float32, configs=1, key=0):
    """(JAX model, its init, the port's model from that init)."""
    jmodel = jc.MLPClassifier(d, hidden, dropout=dropout)
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(key)))
    model = pc.MLPClassifier(d, hidden, dropout, configs=configs,
                             dtype=dtype)
    classifier_from_jax(params, model)
    return jmodel, params, model


def jax_masks(epochs, rows, widths):
    """The uniform draws under JAX's Bernoulli masks, per epoch and hidden
    layer: key, drop_key = split(key) each epoch, then key, sub =
    split(drop_key) per layer (models/classifier.py:41-46, :172)."""
    key = host_prng_key(42)
    out = []
    for _ in range(epochs):
        key, k = jax.random.split(key)
        layers = []
        for w in widths:
            k, sub = jax.random.split(k)
            layers.append(np.asarray(jax.random.uniform(sub, (rows, w))))
        out.append(layers)
    return out


def replay(draws):
    def mask_fn(epoch, layer, shape, keep_prob):
        u = torch.from_numpy(np.array(draws[epoch][layer]))
        return u[None] < keep_prob[:, None, None].to(u.dtype)
    return mask_fn


class _Wide:
    """jax.numpy with float32 read as float64: the JAX classifier's fixed
    float32 constants (the carry's inf, the learning rate) widened, so it
    runs in fp64 under jax.enable_x64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def jax_fp64(monkeypatch):
    """Runs the JAX classifier in fp64 inside the test's ``with`` block."""
    monkeypatch.setattr(jc, "jnp", _Wide())
    return lambda: jax.enable_x64(True)


def close_tree(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("w", "b"):
            np.testing.assert_allclose(g[k], np.asarray(w[k]), **tol,
                                       err_msg=k)


# ----------------------------------------------------------- the forward
@pytest.mark.parametrize("hidden", [[32, 16], [116, 64, 32], []])
def test_forward_matches_jax(splits, hidden):
    x = splits[0]
    jmodel, params, model = pair(x.shape[1], hidden)
    want = np.asarray(jmodel.apply(params, x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(got, want, **FWD_TOL)


def test_dropout_forward_matches_jax(splits):
    """Train mode with JAX's masks (rate 0.3)."""
    x = splits[0]
    jmodel, params, model = pair(x.shape[1], HIDDEN, dropout=0.3)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jmodel.apply(params, x, key, train=True))
    k, masks = key, []
    for w in HIDDEN:
        k, sub = jax.random.split(k)
        masks.append(np.asarray(jax.random.bernoulli(sub, 0.7,
                                                     (len(x), w))))
    rate = torch.tensor([0.3])
    with torch.no_grad():
        got = model(torch.from_numpy(x), rate,
                    [torch.from_numpy(m)[None] for m in masks])[0].numpy()
    np.testing.assert_allclose(got, want, **FWD_TOL)


def test_logistic_regression_matches_jax(splits):
    x_tr, x_va, _, y_tr, y_va, _ = splits
    jmodel = jc.LogisticRegressionModel(x_tr.shape[1])
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(1)))
    model = pc.LogisticRegressionModel(x_tr.shape[1])
    classifier_from_jax(params, model)
    assert len(model.layers) == 1
    np.testing.assert_allclose(
        model(torch.from_numpy(x_va))[0].detach().numpy(),
        np.asarray(jmodel.apply(params, x_va)), **FWD_TOL)
    jbest, jhist = jc.train_classifier(jmodel, params, x_tr, y_tr, x_va,
                                       y_va, 100, 1e-3, 0.5, 10, 1e-9)
    best, hist = pc.train_classifier(model, x_tr, y_tr, x_va, y_va, 100,
                                     1e-3, 0.5, 10, 1e-9)
    for k in ("train_loss", "val_loss"):
        np.testing.assert_allclose(hist[k], np.asarray(jhist[k]), **LOSS_TOL)
    np.testing.assert_array_equal(hist["lr"], np.asarray(jhist["lr"]))
    close_tree(classifier_to_jax(best, 0), jbest, PARAM_TOL)


# ------------------------------------------------------------ evaluation
@pytest.mark.parametrize("case", ["trained", "one class", "no positive"])
def test_metrics_equal_jax(splits, case):
    _, _, x_te, _, _, y_te = splits
    jmodel, params, model = pair(x_te.shape[1], HIDDEN, key=3)
    if case == "one class":
        y_te = np.zeros_like(y_te)
    if case == "no positive":
        # a last-layer bias that predicts class 0 everywhere
        params[-1]["b"] = np.array([8.0, -8.0], np.float32)
        classifier_from_jax(params, model)
    want = jc.evaluate_classifier(jmodel, params, x_te, y_te)
    got = pc.evaluate_classifier(model, x_te, y_te)
    assert list(got) == METRICS
    if case == "no positive":
        assert got["Sensitivity (Recall for class 1)"] == 0.0
    for k in METRICS[:4]:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), k
    if np.isnan(want["AUROC"]):
        assert np.isnan(got["AUROC"])
    else:
        assert got["AUROC"] == pytest.approx(want["AUROC"], abs=1e-4)


# ---------------------------------------------------------- trajectories
@pytest.mark.parametrize("dropout", [0.0, 0.3])
@pytest.mark.parametrize("precision,epochs", [("fp64", EPOCHS),
                                              ("fp32", 150),
                                              ("fp32", EPOCHS)])
def test_train_classifier_matches_jax(splits, dropout, precision, epochs,
                                      monkeypatch):
    x_tr, x_va, _, y_tr, y_va, _ = splits
    fp64 = precision == "fp64"
    jmodel, params, model = pair(
        x_tr.shape[1], HIDDEN, dropout,
        dtype=torch.float64 if fp64 else torch.float32)
    hyper = dict(num_epochs=epochs, initial_lr=1e-4, factor=0.5,
                 patience=10, min_lr=1e-9)
    if fp64:
        monkeypatch.setattr(jc, "jnp", _Wide())
    with jax.enable_x64(fp64):
        cast = np.float64 if fp64 else np.float32
        jparams = jax.tree_util.tree_map(lambda a: a.astype(cast), params)
        jbest, jhist = jc.train_classifier(
            jmodel, jparams, x_tr.astype(cast), y_tr, x_va.astype(cast),
            y_va, **hyper)
        jbest = jax.tree_util.tree_map(np.asarray, jbest)
        jhist = {k: np.asarray(v) for k, v in jhist.items()}
        draws = jax_masks(epochs, len(x_tr), HIDDEN) if dropout else None
    best, hist = pc.train_classifier(
        model, x_tr, y_tr, x_va, y_va, **hyper,
        mask_fn=replay(draws) if dropout else None)
    assert all(v.shape == (epochs,) for v in hist.values())
    if fp64:
        for k in ("train_loss", "val_loss", "lr"):
            np.testing.assert_allclose(hist[k], jhist[k], **FP64_TOL,
                                       err_msg=k)
        close_tree(classifier_to_jax(best, 0), jbest, FP64_TOL)
        return
    long_run = epochs == EPOCHS
    for k in ("train_loss", "val_loss"):
        np.testing.assert_allclose(
            hist[k], jhist[k], **(GRID_VAL_TOL if long_run else LOSS_TOL),
            err_msg=k)
    np.testing.assert_array_equal(hist["lr"], jhist["lr"])
    close_tree(classifier_to_jax(best, 0), jbest,
               DRIFT_TOL if long_run else PARAM_TOL)


def test_early_stopping_freezes_as_jax(splits, jax_fp64):
    """A high learning rate overfits within a few epochs: after
    early_stopping_patience epochs without a better validation loss the
    run stops, and from then on the parameters, the learning rate and the
    losses stay where they were, in both packages (fp64)."""
    x_tr, x_va, _, y_tr, y_va, _ = splits
    jmodel, params, model = pair(x_tr.shape[1], HIDDEN, dtype=torch.float64)
    hyper = dict(num_epochs=80, initial_lr=5e-2, factor=0.5, patience=3,
                 min_lr=1e-9, early_stopping_patience=6)
    with jax_fp64():
        jparams = jax.tree_util.tree_map(lambda a: a.astype(np.float64),
                                         params)
        jbest, jhist = jc.train_classifier(
            jmodel, jparams, x_tr.astype(np.float64), y_tr,
            x_va.astype(np.float64), y_va, **hyper)
        jbest = jax.tree_util.tree_map(np.asarray, jbest)
        jhist = {k: np.asarray(v) for k, v in jhist.items()}
    best, hist = pc.train_classifier(model, x_tr, y_tr, x_va, y_va, **hyper)
    stop = int(np.argmin(jhist["val_loss"])) + hyper[
        "early_stopping_patience"]
    assert stop < 60, jhist["val_loss"]
    for k in ("train_loss", "val_loss", "lr"):
        np.testing.assert_allclose(hist[k], jhist[k], **FP64_TOL, err_msg=k)
        # frozen: every epoch after the stop repeats the first one after it
        assert np.all(hist[k][stop + 1:] == hist[k][stop + 1]), k
    close_tree(classifier_to_jax(best, 0), jbest, FP64_TOL)
    # the last parameters are the frozen ones: one more epoch's loss
    with torch.no_grad():
        logits = model(torch.from_numpy(x_tr).double())
    loss = pc.cross_entropy_logits(logits, torch.from_numpy(
        y_tr.astype(np.int64))[None])
    assert float(loss[0]) == float(hist["train_loss"][-1])


GRID = [
    {"initial_lr": 1e-2, "factor": 0.5, "patience": 3, "min_lr": 1e-6,
     "dropout": 0.0},
    {"initial_lr": 1e-3, "factor": 0.9, "patience": 1, "min_lr": 1e-5,
     "dropout": 0.0},
    {"initial_lr": 5e-4, "factor": 0.5, "patience": 10, "min_lr": 1e-9,
     "dropout": 0.3},
]


def test_sweep_equals_sequential_runs(splits):
    """Each grid point (one of them with dropout) against its own
    train_classifier run on the same draws."""
    x_tr, x_va, _, y_tr, y_va, _ = splits
    _, params, model = pair(x_tr.shape[1], HIDDEN)
    epochs = 60
    draws = jax_masks(epochs, len(x_tr), HIDDEN)
    best, hists = pc.sweep_classifiers(model, x_tr, y_tr, x_va, y_va,
                                       epochs, GRID, mask_fn=replay(draws))
    assert best.configs == len(GRID) and len(hists) == len(GRID)
    for s, cfg in enumerate(GRID):
        one = pc.MLPClassifier(x_tr.shape[1], HIDDEN, cfg["dropout"])
        classifier_from_jax(params, one)
        ref_best, ref_hist = pc.train_classifier(
            one, x_tr, y_tr, x_va, y_va, epochs, cfg["initial_lr"],
            cfg["factor"], cfg["patience"], cfg["min_lr"],
            mask_fn=replay(draws))
        np.testing.assert_allclose(hists[s]["val_loss"], ref_hist["val_loss"],
                                   **GRID_VAL_TOL)
        np.testing.assert_array_equal(hists[s]["lr"], ref_hist["lr"])
        close_tree(classifier_to_jax(best, s),
                   classifier_to_jax(ref_best, 0), PARAM_TOL)


def test_sweep_matches_jax_sweep(splits, jax_fp64):
    """The grid against JAX's vmapped grid (fp64), every point seeded
    alike: histories and best parameters within 1e-9 relative."""
    x_tr, x_va, _, y_tr, y_va, _ = splits
    jmodel, params, model = pair(x_tr.shape[1], HIDDEN, dtype=torch.float64)
    epochs = 60
    with jax_fp64():
        jparams = jax.tree_util.tree_map(lambda a: a.astype(np.float64),
                                         params)
        jbest, jhists = jc.sweep_classifiers(
            jmodel, jparams, x_tr.astype(np.float64), y_tr,
            x_va.astype(np.float64), y_va, epochs, GRID)
        draws = jax_masks(epochs, len(x_tr), HIDDEN)
    best, hists = pc.sweep_classifiers(model, x_tr, y_tr, x_va, y_va,
                                       epochs, GRID, mask_fn=replay(draws))
    for s in range(len(GRID)):
        for k in ("train_loss", "val_loss", "lr"):
            np.testing.assert_allclose(hists[s][k], jhists[s][k],
                                       **FP64_TOL, err_msg=k)
        close_tree(classifier_to_jax(best, s), jbest[s], FP64_TOL)


def test_sweep_mesh_exits_citing_multi_device(splits):
    x_tr, x_va, _, y_tr, y_va, _ = splits
    _, _, model = pair(x_tr.shape[1], HIDDEN)
    with pytest.raises(SystemExit, match="Multi-device"):
        pc.sweep_classifiers(model, x_tr, y_tr, x_va, y_va, 2, GRID,
                             mesh=object())


@pytest.mark.parametrize("configs", [1, 3])
def test_interop_round_trip(configs):
    jmodel = jc.MLPClassifier(10, [8, 4])
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(2)))
    model = pc.MLPClassifier(10, [8, 4], configs=configs)
    classifier_from_jax(params, model)
    for s in range(configs):
        close_tree(classifier_to_jax(model, s), params,
                   dict(rtol=0, atol=0))
    stacked = classifier_to_jax(model)
    assert stacked[0]["w"].shape == (configs, 10, 8)
    again = pc.MLPClassifier(10, [8, 4], configs=configs)
    classifier_from_jax(stacked, again)
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ CLI
def test_cli_matches_jax_cli(cohort, tmp_path, monkeypatch):
    """The port's CLI and the JAX CLI on one cohort from one init (the JAX
    CLI's host_init_params, carried across): the same metric keys, the
    four count-based metrics equal, AUROC within 1e-4; the files written;
    the checkpoint restoring the same tree in both packages."""
    flags = ["--fmri_path", cohort[0], "--labels_path", cohort[1],
             "--num_epochs", str(EPOCHS), "--hidden_layers",
             *map(str, HIDDEN)]
    runs = {}
    for name in ("jax", "port"):
        root = tmp_path / name
        root.mkdir()
        monkeypatch.chdir(root)
        argv = flags + ["--checkpoint_path", str(root / "best_model.pth")]
        if name == "jax":
            runs[name] = jax_cli.main(jax_cli.build_parser().parse_args(argv))
        else:
            def init_fn(d, hidden, dropout, device):
                jmodel = jc.MLPClassifier(d, hidden, dropout)
                model = pc.MLPClassifier(d, hidden, dropout)
                return classifier_from_jax(jax.tree_util.tree_map(
                    np.asarray, jmodel.init_params(jax.random.PRNGKey(42))),
                    model, device)
            runs[name] = classifier_baseline.run(argv + ["--device", "cpu"],
                                                 init_fn=init_fn)
        assert (root / "best_model_metrics.txt").exists()
        assert (root / "logs" / "experiment.log").exists()
        record = json.loads((root / "experiment_results.json").read_text())
        assert list(record["metrics"]) == METRICS
    assert list(runs["port"]) == list(runs["jax"]) == METRICS
    for k in METRICS[:4]:
        assert runs["port"][k] == pytest.approx(runs["jax"][k], rel=1e-12), k
    assert runs["port"]["AUROC"] == pytest.approx(runs["jax"]["AUROC"],
                                                  abs=1e-4)
    port_tree, port_cfg = read_flax_checkpoint(tmp_path / "port",
                                               "best_model")
    jax_tree, jax_cfg = read_flax_checkpoint(tmp_path / "jax", "best_model")
    assert port_cfg == jax_cfg
    close_tree(port_tree, jax_tree, DRIFT_TOL)
    # the JAX package restores the port's checkpoint into its own tree
    template = jax_load_checkpoint(tmp_path / "jax", name="best_model")[0]
    restored, _ = jax_load_checkpoint(tmp_path / "port", template,
                                      name="best_model")
    restored = jax.tree_util.tree_map(np.asarray, restored)
    close_tree([restored[str(i)] for i in range(len(restored))], port_tree,
               dict(rtol=0, atol=0))
    text = (tmp_path / "port" / "best_model_metrics.txt").read_text()
    assert [line.split(":")[0] for line in text.splitlines()] == METRICS


def test_cli_device_flag():
    parser = classifier_baseline.build_parser()
    assert parser.parse_args([]).device == "cuda"
    with pytest.raises(SystemExit):
        parser.parse_args(["--device", "tpu"])
    jax_flags = {a.dest for a in jax_cli.build_parser()._actions}
    assert {a.dest for a in parser._actions} == jax_flags
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            classifier_baseline.main(argparse.Namespace(
                **vars(parser.parse_args([]))))
