"""The FI regression model, the per-epoch shuffle and ``evaluate_regression``
of the port against the JAX package and scikit-learn, on the CPU.

The JAX ``init_params`` tree of ``RegressionCVAE`` (the cvae skeleton plus
the ``regressor`` MLP) goes into the port's fold-stacked model through
``params_from_jax``, and the JAX noise ``normal(key, mu.shape)`` is
replayed. Bounds, those of tests/test_torch_zoo.py: forward leaves and loss
terms rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-6. The shuffled
trajectory: two folds of 37 and 21 subjects in batches of 16 (the small
fold has an all-padding batch at the end of the stacked grid), 4 epochs,
against the JAX package's sequential per-fold trainer on the replayed noise
and permutations, logs rtol 1e-4, parameters rtol 5e-3 / atol 1e-5.
"""
import jax
import numpy as np
import pytest
import torch
from flax import serialization
from sklearn.metrics import mean_absolute_error, mean_squared_error, r2_score

from multi_modal_normative_modeling_tpu.models.regression import (
    RegressionCVAE as JaxRegression,
)
from multi_modal_normative_modeling_tpu.train import (
    FoldTrainer as JaxFoldTrainer,
    TrainConfig as JaxConfig,
)
from multi_modal_normative_modeling_tpu.train.trainer import (
    make_batches as jax_make_batches,
)
from multi_modal_normative_modeling_tpu_torch.evaluation.metrics import (
    evaluate_regression,
)
from multi_modal_normative_modeling_tpu_torch.interop import (
    params_from_jax,
    params_to_jax,
)
from multi_modal_normative_modeling_tpu_torch.models import RegressionCVAE
from multi_modal_normative_modeling_tpu_torch.models.regression import (
    regression_loss_fn,
)
from multi_modal_normative_modeling_tpu_torch.ops.linear import (
    apply_mlp,
    init_mlp,
)
from multi_modal_normative_modeling_tpu_torch.parallel import (
    MultiFoldTrainer,
    stack_fold_batches,
    stack_params,
)
from multi_modal_normative_modeling_tpu_torch.train import (
    TrainConfig,
    make_batches,
)
from multi_modal_normative_modeling_tpu_torch.train.checkpoints import (
    to_bytes,
)
from multi_modal_normative_modeling_tpu_torch.train.trainer import (
    DeviceBatches,
    FoldNoise,
)
from tests.test_torch_endtoend import close, jax_draws, numpy_tree, t
from tests.test_torch_threads import one_torch_thread  # noqa: F401

DIMS = [24, 40, 16]
HIDDEN = [12, 12]
Z = 6
C = 2
B = 20
FOLDS = 2
TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def make_pair(folds=FOLDS, seed=0):
    jmodel = JaxRegression(DIMS, HIDDEN, Z, C, len(DIMS))
    trees = [numpy_tree(jmodel.init_params(jax.random.PRNGKey(seed + f)))
             for f in range(folds)]
    model = RegressionCVAE(DIMS, HIDDEN, Z, C, len(DIMS), folds=folds)
    params_from_jax(stack_params(trees), model)
    return jmodel, trees, model


def make_inputs(seed, rows=B, folds=FOLDS):
    rng = np.random.default_rng(seed)
    xes = [[rng.standard_normal((rows, d)).astype(np.float32) for d in DIMS]
           for _ in range(folds)]
    cs = [rng.standard_normal((rows, C)).astype(np.float32)
          for _ in range(folds)]
    fi = [rng.uniform(0, 30, rows).astype(np.float32) for _ in range(folds)]
    return xes, cs, fi


def stacked(xes, cs):
    return ([t(np.stack([xes[f][m] for f in range(len(xes))]))
             for m in range(len(DIMS))], [t(np.stack(cs))] * len(DIMS))


# ---- evaluate_regression ----------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [2, 7, 64, 1000])
def test_evaluate_regression_equals_sklearn(dtype, n):
    """RMSE, MAE and R^2 equal scikit-learn's exactly (the JAX CLI's
    evaluate_regression, cli/regression.py:26-33), on the CLI's [n, 1]
    float32 arrays and others; MAPE is the reference's formula."""
    rng = np.random.default_rng(n)
    for shape in ((n, 1), (n,)):
        y_true = rng.uniform(1, 30, shape).astype(dtype)
        y_pred = (y_true + rng.standard_normal(shape)).astype(dtype)
        got = evaluate_regression(y_true, y_pred)
        assert got["RMSE"] == np.sqrt(mean_squared_error(y_true, y_pred))
        assert got["MAE"] == mean_absolute_error(y_true, y_pred)
        assert got["R2"] == r2_score(y_true, y_pred)
        assert got["MAPE"] == np.mean(
            np.abs((y_true - y_pred) / (y_true + 1e-6))) * 100


def test_evaluate_regression_constant_and_perfect_targets():
    y = np.full((5, 1), 3.0, np.float32)
    for pred in (y, y + 1):
        got = evaluate_regression(y, pred)
        assert got["R2"] == r2_score(y, pred)
        assert got["RMSE"] == np.sqrt(mean_squared_error(y, pred))


# ---- the MLP ops ------------------------------------------------------------

def test_init_and_apply_mlp_fold_layout():
    layers = init_mlp([7, 5, 3], folds=2,
                      generator=torch.Generator().manual_seed(0))
    assert [tuple(layer.weight.shape) for layer in layers] == [(2, 5, 7),
                                                               (2, 3, 5)]
    x = torch.randn(2, 4, 7)
    pairs = [layer.pair() for layer in layers]
    got = apply_mlp(pairs, x, activation=torch.relu)
    want = torch.relu(x @ pairs[0][0].mT + pairs[0][1][:, None]) \
        @ pairs[1][0].mT + pairs[1][1][:, None]
    assert torch.equal(got, want)


# ---- the model --------------------------------------------------------------

@pytest.mark.parametrize("combine", ["gpoe", "poe"])
@pytest.mark.parametrize("mask_kind", ["none", "ragged"])
def test_forward_loss_and_gradients_match_jax(combine, mask_kind):
    jmodel, trees, model = make_pair()
    xes, cs, fi = make_inputs(1)
    mask = None
    if mask_kind == "ragged":
        mask = np.ones((FOLDS, B), np.float32)
        mask[0, 11:] = 0.0
        mask[1, 17:] = 0.0
    keys = [jax.random.PRNGKey(30 + f) for f in range(FOLDS)]
    eps = np.stack([np.asarray(jax.random.normal(k, (B, Z))) for k in keys])
    tx, tc = stacked(xes, cs)
    tmask = None if mask is None else t(mask)
    fwd = model(tx, tc, combine, eps=t(eps))
    terms = model.loss(tx, fwd, t(np.stack(fi)), mask=tmask)
    assert set(terms) == set(model.log_keys)
    terms["total"].sum().backward()
    for f in range(FOLDS):
        m = None if mask is None else mask[f]

        def objective(p, f=f, m=m):
            out = jmodel.forward(p, xes[f], [cs[f]] * len(DIMS), keys[f],
                                 combine)
            lo = jmodel.loss(p, xes[f], out, fi[f], mask=m)
            return lo["total"], (out, lo)

        (_, (ref, ref_terms)), ref_grads = jax.value_and_grad(
            objective, has_aux=True)(trees[f])
        for k in model.log_keys:
            close(terms[k][f].detach(), ref_terms[k], err_msg=k, **TOL)
        close(fwd["fi_pred"][f].detach(), ref["fi_pred"], **TOL)
        for mean, rmean in zip(fwd["recon_means"], ref["recon_means"]):
            close(mean[f].detach(), rmean, **TOL)
        for layer, ref_layer in zip(model.regressor, ref_grads["regressor"]):
            close(layer.weight.grad[f].T, ref_layer["w"], **GRAD_TOL)
            close(layer.bias.grad[f], ref_layer["b"], **GRAD_TOL)
        for enc, ref_enc in zip(model.enc, ref_grads["enc"]):
            close(enc.hidden[0].weight.grad[f].T, ref_enc["hidden"][0]["w"],
                  **GRAD_TOL)
            close(enc.mu.bias.grad[f], ref_enc["mu"]["b"], **GRAD_TOL)
        if combine == "gpoe":
            close(model.alpha.grad[f], ref_grads["alpha"], **GRAD_TOL)
        else:  # PoE takes no weights
            assert model.alpha.grad is None
            assert not np.any(np.asarray(ref_grads["alpha"]))


def test_scoring_paths_match_jax():
    """``pred_fi`` (encoder and decoder-mean kernels' wrappers, their plain
    versions on CPU tensors) and ``roiwise_deviation`` against JAX per
    fold, and each equal to its plain torch path."""
    jmodel, trees, model = make_pair(seed=2)
    xes, cs, _ = make_inputs(3, rows=45)
    keys = [jax.random.PRNGKey(900 + f) for f in range(FOLDS)]
    eps = t(np.stack([np.asarray(jax.random.normal(k, (45, Z)))
                      for k in keys]))
    tx, tc = stacked(xes, cs)
    fi = model.pred_fi(tx, tc, "gpoe", eps=eps)
    assert fi.shape == (FOLDS, 45, 1)
    assert torch.equal(fi, model.pred_fi_reference(tx, tc, "gpoe", eps=eps))
    dev = model.roiwise_deviation(tx[1], tc[1], 1, eps=eps)
    assert dev.shape == (FOLDS, 45, DIMS[1])
    assert torch.equal(dev, model.roiwise_deviation_reference(
        tx[1], tc[1], 1, eps=eps))
    for f in range(FOLDS):
        close(fi[f], jmodel.pred_fi(trees[f], xes[f], [cs[f]] * len(DIMS),
                                    keys[f], "gpoe"), **TOL)
        close(dev[f], jmodel.roiwise_deviation(trees[f], xes[f][1], cs[f],
                                               keys[f], 1), **TOL)


def test_interop_round_trip_and_checkpoint_bytes():
    _, trees, model = make_pair(seed=4)
    for f in range(FOLDS):
        got = params_to_jax(model, fold=f)
        assert sorted(got) == ["alpha", "dec", "enc", "regressor"]
        assert to_bytes(got) == serialization.to_bytes(trees[f])


# ---- batches with extras, and the shuffle -------------------------------------

def _cohort(rng, n):
    data = [rng.standard_normal((n, d)).astype(np.float32) for d in DIMS]
    cov = rng.standard_normal((n, C)).astype(np.float32)
    fi = rng.uniform(0, 30, n).astype(np.float32)
    return data, [cov] * len(DIMS), {"fi": fi[:, None]}


def test_make_batches_carries_extras_as_jax_does():
    rng = np.random.default_rng(5)
    data, cov, extras = _cohort(rng, 37)
    got = make_batches(data, cov, 16, extras)
    ref = jax_make_batches(data, cov, 16, extras)
    assert set(got) == set(ref)
    assert np.array_equal(got["extras"]["fi"], ref["extras"]["fi"])
    assert np.array_equal(got["mask"], ref["mask"])
    small = [d[:21] for d in data]
    both = stack_fold_batches([data, small], [cov, [c[:21] for c in cov]],
                              16, extras=[extras, {"fi": extras["fi"][:21]}])
    assert both["extras"]["fi"].shape == (2, 3, 16, 1)
    assert not both["extras"]["fi"][1, 2].any()


def test_permuted_batches_keep_padding_batches_in_place():
    """A fold's shuffle covers its own nb_f * B rows: x, c, mask and the
    extras move together, its trailing all-padding batches stay, and every
    batch the fold had real rows in keeps some."""
    rng = np.random.default_rng(6)
    cohorts = [_cohort(rng, 37), _cohort(rng, 21)]
    batches = DeviceBatches(stack_fold_batches(
        [c[0] for c in cohorts], [c[1] for c in cohorts], 16,
        extras=[c[2] for c in cohorts]), "cpu")
    assert batches.fold_rows() == [48, 32]
    noise = FoldNoise(2, (16, Z), 42, "cpu")
    order = noise.permutation(0, batches.fold_rows(), 48)
    assert sorted(order[0].tolist()) == list(range(48))
    assert order[1, 32:].tolist() == list(range(32, 48))
    moved = batches.permuted(order)
    for f, (n, rows) in enumerate(((37, 48), (21, 32))):
        flat_x = moved.x[0][:, f].reshape(48, -1)
        flat_fi = moved.extras["fi"][:, f].reshape(48)
        flat_mask = moved.mask[:, f].reshape(48)
        assert flat_mask.sum() == n
        assert not flat_mask[rows:].any()
        real = flat_mask > 0
        src = torch.from_numpy(cohorts[f][0][0])
        # the real rows are the fold's rows, each once, with their FI
        got = {tuple(r.tolist()): v.item()
               for r, v in zip(flat_x[real], flat_fi[real])}
        want = {tuple(r.tolist()): v for r, v in
                zip(src, cohorts[f][2]["fi"][:, 0].tolist())}
        assert got == want
        per_batch = moved.mask[:, f].sum(dim=1)
        assert ((per_batch > 0).numpy() == batches.valid_host[:, f]).all()


def test_shuffled_ragged_two_fold_trajectory_matches_jax():
    """The regression CLI's training (shuffle, FI extra, its loss) in the
    port's MultiFoldTrainer against the JAX package's sequential per-fold
    trainer, the path the JAX CLI takes (cli/common.py:888-896), from one
    init and key 42 per fold, on the replayed noise and permutations."""
    jmodel, trees, model = make_pair(folds=2, seed=8)
    tree = trees[0]
    params_from_jax(stack_params([tree, tree]), model)
    rng = np.random.default_rng(8)
    cohorts = [_cohort(rng, n) for n in (37, 21)]
    epochs, batch = 4, 16
    jconfig = JaxConfig(epochs=epochs, batch_size=batch, learning_rate=1e-4,
                        combine="gpoe", shuffle=True, seed=42)

    def jax_loss(p, b, k):
        fwd = jmodel.forward(p, list(b["x"]), list(b["c"]), k, "gpoe")
        lo = jmodel.loss(p, list(b["x"]), fwd, b["extras"]["fi"][:, 0],
                         lambda_reg=1.0, mask=b["mask"])
        return lo["total"], lo

    trainer = JaxFoldTrainer(jmodel, jconfig, 37, loss_fn=jax_loss)
    refs = [trainer.run(tree, c[0], c[1], key=jax.random.PRNGKey(42),
                        extras=c[2]) for c in cohorts]

    config = TrainConfig(epochs=epochs, batch_size=batch, combine="gpoe",
                         shuffle=True)
    batches = stack_fold_batches([c[0] for c in cohorts],
                                 [c[1] for c in cohorts], batch,
                                 extras=[c[2] for c in cohorts])
    assert batches["valid"].tolist() == [[True] * 3, [True, True, False]]
    draws = jax_draws(batches["valid"], epochs, batch, Z, shuffle=True)
    logs = MultiFoldTrainer(model, config, 37,
                            loss_fn=regression_loss_fn(model, "gpoe")).run(
        batches, **draws)
    assert set(logs) == set(model.log_keys)
    for f, (ref_params, ref_logs) in enumerate(refs):
        for k in model.log_keys:
            assert np.isfinite(logs[k][f]).all()
            close(logs[k][f], np.asarray(ref_logs[k]), rtol=1e-4, err_msg=k)
        got = params_to_jax(model, fold=f)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(numpy_tree(ref_params))):
            close(a, b, rtol=5e-3, atol=1e-5)
    # every epoch reorders both folds; fold 1's padding batch stays last
    for epoch in range(epochs):
        assert not np.array_equal(draws["perms"][epoch, 0], np.arange(48))
        assert draws["perms"][epoch, 1, 32:].tolist() == list(range(32, 48))


def test_replayed_draws_take_arrays_or_tensors():
    """The replay hooks take numpy arrays or tensors (the card's checks
    hand over tensors already on the device) and train alike."""
    rng = np.random.default_rng(10)
    cohort = _cohort(rng, 20)
    batches = stack_fold_batches([cohort[0]] * 2, [cohort[1]] * 2, 8,
                                 extras=[cohort[2]] * 2)
    draws = jax_draws(batches["valid"], 2, 8, Z, shuffle=True)
    states = []
    for convert in (np.asarray, torch.from_numpy):
        _, trees, model = make_pair(folds=2, seed=10)
        config = TrainConfig(epochs=2, batch_size=8, combine="gpoe",
                             shuffle=True)
        MultiFoldTrainer(model, config, 20,
                         loss_fn=regression_loss_fn(model, "gpoe")).run(
            batches, **{k: convert(v) for k, v in draws.items()})
        states.append(model.state_dict())
    for k, v in states[0].items():
        assert torch.equal(v, states[1][k]), k


def test_production_shuffle_is_seeded_per_fold():
    """Without replayed draws each fold draws its permutations and noise
    from its own generator seeded 42: two runs train alike, two folds that
    start alike on the same data stay alike, and shuffling changes the
    trajectory."""
    rng = np.random.default_rng(9)
    cohort = _cohort(rng, 30)

    def train(shuffle):
        _, trees, model = make_pair(folds=2, seed=9)
        params_from_jax(stack_params([trees[0], trees[0]]), model)
        config = TrainConfig(epochs=2, batch_size=8, combine="gpoe",
                             shuffle=shuffle)
        MultiFoldTrainer(model, config, 30,
                         loss_fn=regression_loss_fn(model, "gpoe")).run(
            stack_fold_batches([cohort[0]] * 2, [cohort[1]] * 2, 8,
                               extras=[cohort[2]] * 2))
        return model.state_dict()

    a, b, plain = train(True), train(True), train(False)
    for k, v in a.items():
        assert torch.equal(v, b[k]), k
        assert torch.equal(v[0], v[1]), k
    assert any(not torch.equal(v, plain[k]) for k, v in a.items())
