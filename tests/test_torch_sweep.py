"""The port's hyperparameter grid trainer (parallel/sweep.py) on the CPU.

S configs x F folds train as one end-to-end model of S * F stacked folds.
Held: ``stack_hypers`` against the JAX package's; the loss with its margin
and contrastive weight given as one value per fold against the same loss
with the values as floats (bit-equal); ``SweepTrainer`` against one
MultiFoldTrainer run per config, and against the JAX package's
SweepTrainer from the same init and replayed draws, at the bounds of the
JAX package's own sweep test (tests/test_sweep.py:46-83: parameters rtol
5e-3 / atol 5e-4, the total loss rtol 2e-3), where stacking changes the
products' batch count.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_normative_modeling_tpu.models.endtoend import (
    EndToEndCVAE as JaxEndToEnd,
)
from multi_modal_normative_modeling_tpu.parallel.folds import (
    stack_fold_batches as jax_stack_fold_batches,
)
from multi_modal_normative_modeling_tpu.parallel.sweep import (
    SweepTrainer as JaxSweepTrainer,
    stack_hypers as jax_stack_hypers,
)
from multi_modal_normative_modeling_tpu.train import TrainConfig as JaxConfig
from multi_modal_normative_modeling_tpu_torch.interop import (
    params_from_jax,
    params_to_jax,
)
from multi_modal_normative_modeling_tpu_torch.models.endtoend import (
    EndToEndCVAE,
    endtoend_loss_fn,
)
from multi_modal_normative_modeling_tpu_torch.ops.losses import (
    margin_contrastive,
)
from multi_modal_normative_modeling_tpu_torch.parallel import (
    MultiFoldTrainer,
    stack_fold_batches,
    stack_params,
)
from multi_modal_normative_modeling_tpu_torch.parallel.sweep import (
    SweepTrainer,
    repeat_folds,
    stack_hypers,
)
from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
from tests.test_torch_endtoend import _sign_noise_leaf, jax_draws
from tests.test_torch_threads import one_torch_thread  # noqa: F401

DIMS, C, Z = [18, 24], 5, 6
HIDDEN, LAYERS = [12, 12], [8]
SIZES = (40, 29)          # fold 1 gets an all-padding third batch
BATCH, EPOCHS = 16, 4
CONFIGS = [{"margin": 0.5, "wcon": 0.1}, {"margin": 2.0, "wcon": 1.0},
           {"margin": 1.0, "wcon": 0.5}]
PARAM_TOL = dict(rtol=5e-3, atol=5e-4)
LOSS_TOL = dict(rtol=2e-3)


def _cohorts():
    rng = np.random.default_rng(0)
    data, cov, extras = [], [], []
    for n in SIZES:
        data.append([rng.normal(size=(n, d)).astype(np.float32)
                     for d in DIMS])
        cov.append([rng.normal(size=(n, C)).astype(np.float32)] * len(DIMS))
        extras.append({"labels": rng.integers(0, 2, size=n).astype(
            np.float32)[:, None]})
    return data, cov, extras


def _model(folds, tree):
    model = EndToEndCVAE(DIMS, HIDDEN, Z, C, len(DIMS),
                         classifier_layers=LAYERS, dropout_rate=0.5,
                         folds=folds)
    params_from_jax(stack_params([tree] * folds), model)
    return model


def _jax_tree():
    jmodel = JaxEndToEnd(DIMS, HIDDEN, Z, C, len(DIMS),
                         classifier_layers=LAYERS, dropout_rate=0.5)
    tree = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(42)))
    return jmodel, tree


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}['{k}']")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, np.asarray(tree)


def _close_grid(got, want, skip=lambda path: False, **tol):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert np.isfinite(got[path]).all(), path
        if not skip(path):
            np.testing.assert_allclose(got[path], leaf, err_msg=path, **tol)


def test_stack_hypers_matches_jax():
    ref = jax_stack_hypers(CONFIGS)
    got = stack_hypers(CONFIGS)
    assert set(got) == set(ref) == {"margin", "wcon"}
    for k in got:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    # each config's value over its folds, config-major
    assert stack_hypers(CONFIGS, folds=2)["margin"].tolist() == [
        0.5, 0.5, 2.0, 2.0, 1.0, 1.0]
    with pytest.raises(ValueError, match="same keys"):
        stack_hypers([{"margin": 1.0}, {"wcon": 1.0}])


def test_repeat_folds_is_config_major():
    data, cov, extras = _cohorts()
    batches = stack_fold_batches(data, cov, BATCH, extras=extras)
    out = repeat_folds(batches, 3)
    assert out["mask"].shape == (6,) + batches["mask"].shape[1:]
    for s in range(3):
        for key in ("mask", "valid"):
            np.testing.assert_array_equal(out[key][2 * s:2 * s + 2],
                                          batches[key])
        np.testing.assert_array_equal(out["x"][1][2 * s:2 * s + 2],
                                      batches["x"][1])
        np.testing.assert_array_equal(
            out["extras"]["labels"][2 * s:2 * s + 2],
            batches["extras"]["labels"])


@pytest.mark.parametrize("margin,wcon", [(0.5, 0.1), (1.0, 1.0),
                                         (2.0, 0.5)])
def test_per_fold_hyperparameters_equal_floats(margin, wcon):
    """One value per fold gives the float's result bit for bit: the
    contrastive term and the whole loss, forward and gradients."""
    rng = np.random.default_rng(1)
    dev_h = torch.from_numpy(rng.random((3, 20), np.float32))
    dev_d = torch.from_numpy(rng.random((3, 20), np.float32))
    labels = torch.from_numpy(rng.integers(0, 2, (3, 20)).astype(np.float32))
    mask = torch.ones(3, 20)
    mask[1, 15:] = 0.0
    assert torch.equal(
        margin_contrastive(dev_h, dev_d, labels, torch.full((3,), margin),
                           mask),
        margin_contrastive(dev_h, dev_d, labels, margin, mask))

    _, tree = _jax_tree()
    data, cov, extras = _cohorts()
    batch = stack_fold_batches(data, cov, BATCH, extras=extras)
    step = {"x": [torch.from_numpy(a[:, 0]) for a in batch["x"]],
            "c": [torch.from_numpy(a[:, 0]) for a in batch["c"]],
            "mask": torch.from_numpy(batch["mask"][:, 0]),
            "extras": {"labels": torch.from_numpy(
                batch["extras"]["labels"][:, 0])}}
    eps = torch.from_numpy(rng.standard_normal((2, BATCH, Z), np.float32))
    step["keep"] = [torch.from_numpy(rng.random((2, BATCH, w)) < 0.5)
                    for w in _model(2, tree).keep_widths]
    results = []
    for hyper in ((margin, wcon), (torch.full((2,), margin),
                                   torch.full((2,), wcon))):
        model = _model(2, tree)
        total, aux = endtoend_loss_fn(model, *hyper)(step, eps)
        grads = torch.autograd.grad(total.sum(), list(model.parameters()))
        results.append((total, aux, grads))
    (t1, a1, g1), (t2, a2, g2) = results
    assert torch.equal(t1, t2)
    for k in model.log_keys:
        assert torch.equal(a1[k], a2[k]), k
    for x, y in zip(g1, g2):
        assert torch.equal(x, y)


def _sweep(tree, draws=None):
    data, cov, extras = _cohorts()
    batches = stack_fold_batches(data, cov, BATCH, extras=extras)
    model = _model(len(CONFIGS) * 2, tree)
    config = TrainConfig(epochs=EPOCHS, batch_size=BATCH, combine="poe")
    sweep = SweepTrainer(model, config, max(SIZES),
                         lambda h: endtoend_loss_fn(model, h["margin"],
                                                    h["wcon"]),
                         state_update=model.update_state)
    draws = {} if draws is None else draws(repeat_folds(
        batches, len(CONFIGS))["valid"], model)
    return sweep.run(batches, CONFIGS, **draws), batches


def test_sweep_matches_one_run_per_config():
    _, tree = _jax_tree()
    (params_grid, logs_grid), batches = _sweep(tree)
    assert len(params_grid) == len(logs_grid) == len(CONFIGS)
    for s, hyper in enumerate(CONFIGS):
        model = _model(2, tree)
        config = TrainConfig(epochs=EPOCHS, batch_size=BATCH, combine="poe")
        logs = MultiFoldTrainer(
            model, config, max(SIZES),
            loss_fn=endtoend_loss_fn(model, hyper["margin"], hyper["wcon"]),
            state_update=model.update_state).run(batches)
        for f in range(2):
            _close_grid(params_grid[s][f], params_to_jax(model, fold=f),
                        **PARAM_TOL)
            assert logs_grid[s][f]["total_loss"].shape == (EPOCHS,)
            np.testing.assert_allclose(logs_grid[s][f]["total_loss"],
                                       logs["total_loss"][f], **LOSS_TOL)


def test_sweep_matches_the_jax_sweep():
    """JAX's SweepTrainer (every config and fold from key 42, as the JAX
    end-to-end sweep CLI gives them) against the port's on its draws."""
    jmodel, tree = _jax_tree()
    data, cov, extras = _cohorts()

    def jax_loss(p, batch, k, hyper):
        labels = batch["extras"]["labels"][:, 0].astype(jnp.int32)
        fwd = jmodel.forward(p, list(batch["x"]), list(batch["c"]), k,
                             train=True, mask=batch["mask"])
        lo = jmodel.loss(p, list(batch["x"]), fwd, labels,
                         margin=hyper["margin"],
                         weight_contrastive=hyper["wcon"], mask=batch["mask"])
        lo["__bn_state__"] = fwd["bn_state"]
        return lo["total_loss"], lo

    key = jax.random.PRNGKey(42)
    keys = jnp.stack([jnp.stack([key, key]) for _ in CONFIGS])
    ref_params, ref_logs = JaxSweepTrainer(
        jmodel, JaxConfig(epochs=EPOCHS, batch_size=BATCH, combine="poe"),
        max(SIZES), jax_loss,
        lambda p, aux: {**p, "bn_state": aux["__bn_state__"]}).run(
            [tree, tree], jax_stack_fold_batches(data, cov, BATCH,
                                                 extras=extras), keys,
            CONFIGS)
    (params_grid, logs_grid), _ = _sweep(tree, lambda valid, model: jax_draws(
        valid, EPOCHS, BATCH, Z, model.keep_widths))
    for s in range(len(CONFIGS)):
        for f in range(2):
            _close_grid(params_grid[s][f], ref_params[s][f],
                        skip=_sign_noise_leaf, **PARAM_TOL)
            for k, v in ref_logs[s][f].items():
                if k.startswith("__"):
                    continue
                np.testing.assert_allclose(logs_grid[s][f][k], np.asarray(v),
                                           err_msg=k, **LOSS_TOL)


def test_sweep_refuses_a_model_of_another_fold_count():
    _, tree = _jax_tree()
    data, cov, extras = _cohorts()
    model = _model(5, tree)
    sweep = SweepTrainer(model, TrainConfig(epochs=1, batch_size=BATCH,
                                            combine="poe"), max(SIZES),
                         lambda h: endtoend_loss_fn(model, h["margin"],
                                                    h["wcon"]))
    with pytest.raises(ValueError, match="not a multiple"):
        sweep.run(stack_fold_batches(data, cov, BATCH, extras=extras),
                  CONFIGS)
