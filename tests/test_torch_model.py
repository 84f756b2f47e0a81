"""The port's model, interop and fold stacking against the JAX package.

The same JAX-initialized params go into both packages and the same eps,
``jax.random.normal(key, [B, Z])`` (what the JAX reparameterize draws), is
injected into the port. Tolerance rtol 2e-4 / atol 2e-5, the bound of
tests/test_kernels.py for the whole fused inference path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_normative_modeling_tpu.models import build_model as jax_build
from multi_modal_normative_modeling_tpu.train.checkpoints import (
    save_checkpoint,
)
from multi_modal_normative_modeling_tpu_torch.interop import (
    params_from_jax,
    params_to_jax,
    read_flax_checkpoint,
)
from multi_modal_normative_modeling_tpu_torch.models import (
    MultimodalCVAE,
    build_model,
    reparameterize,
)
from multi_modal_normative_modeling_tpu_torch.parallel import stack_params
from tests.test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-5)
DIMS = [90, 90, 90, 270]
HIDDEN = [110, 110]
Z, C = 10, 29


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_model(dims, hidden=HIDDEN, seed=0):
    model = jax_build("cVAE_multimodal", dims, hidden, Z, C, len(dims))
    return model, _numpy_tree(model.init_params(jax.random.PRNGKey(seed)))


def _port(dims, tree, folds=1, hidden=HIDDEN):
    model = build_model("cVAE_multimodal", dims, hidden, Z, C, len(dims),
                        folds=folds)
    return params_from_jax(tree, model)


def _inputs(dims, b, seed=0):
    rng = np.random.default_rng(seed)
    xes = [rng.standard_normal((b, d)).astype(np.float32) for d in dims]
    c = np.zeros((b, C), np.float32)
    c[np.arange(b), rng.integers(0, 27, b)] = 1.0
    c[np.arange(b), 27 + rng.integers(0, 2, b)] = 1.0
    return xes, c


def _assert_trees_equal(a, b):
    leaves_a, tree_a = jax.tree_util.tree_flatten(a)
    leaves_b, tree_b = jax.tree_util.tree_flatten(b)
    assert tree_a == tree_b
    for x, y in zip(leaves_a, leaves_b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


# ---- interop -------------------------------------------------------------

def test_interop_round_trip_one_fold():
    _, tree = _jax_model(DIMS)
    model = _port(DIMS, tree)
    np.testing.assert_array_equal(
        model.enc[0].hidden[0].weight[0].detach().numpy(),
        tree["enc"][0]["hidden"][0]["w"].T)
    assert model.dec[3].logvar_out.shape == (1, 1, 270)
    _assert_trees_equal(params_to_jax(model, fold=0), tree)


def test_interop_round_trip_fold_stacked():
    trees = [_jax_model(DIMS, seed=s)[1] for s in range(3)]
    stacked = stack_params(trees)
    model = _port(DIMS, stacked, folds=3)
    _assert_trees_equal(params_to_jax(model), stacked)
    for f in range(3):
        _assert_trees_equal(params_to_jax(model, fold=f), trees[f])


def test_params_from_jax_rejects_mismatched_tree():
    _, tree = _jax_model(DIMS)
    with pytest.raises(ValueError, match="expects"):
        _port(DIMS, tree, folds=2)
    with pytest.raises(ValueError, match="expects"):
        _port([90, 90, 90, 271], tree)


def test_read_flax_checkpoint_matches_save_checkpoint(tmp_path):
    _, tree = _jax_model(DIMS)
    config = {"model": "cVAE_multimodal", "input_dim_list": DIMS,
              "hidden_dim": HIDDEN, "latent_dim": Z, "c_dim": C,
              "modalities": 4, "non_linear": True, "combine": "gPoE"}
    save_checkpoint(tmp_path, tree, config)
    got, got_config = read_flax_checkpoint(tmp_path)
    assert got_config == config
    _assert_trees_equal(got, tree)


def test_stack_params_numpy_and_tensors():
    trees = [{"a": [np.full((2,), i, np.float32)], "b": torch.full((3,), i)}
             for i in range(4)]
    out = stack_params(trees)
    assert out["a"][0].shape == (4, 2) and isinstance(out["a"][0], np.ndarray)
    assert torch.equal(out["b"][:, 0], torch.arange(4))
    with pytest.raises(ValueError):
        stack_params([])


# ---- model ---------------------------------------------------------------

def _check_against_jax(dims, combine, b=64, hidden=HIDDEN):
    jmodel, tree = _jax_model(dims, hidden)
    model = _port(dims, tree, hidden=hidden)
    xes, c = _inputs(dims, b)
    key = jax.random.PRNGKey(7)
    eps = np.array(jax.random.normal(key, (b, Z)))

    jx = [jnp.asarray(x) for x in xes]
    jc = [jnp.asarray(c)] * len(dims)
    ref = jmodel.pred_recon(tree, jx, jc, key, combine)
    ref_fused, ref_fused_dev = jmodel.pred_recon_fused(tree, jx, jc, key,
                                                       combine, interpret=True)

    tx = [torch.from_numpy(x[None]) for x in xes]
    tc = [torch.from_numpy(c[None])] * len(dims)
    teps = torch.from_numpy(eps[None])
    with torch.no_grad():
        plain = model.pred_recon(tx, tc, combine, eps=teps)
    fused, fused_dev = model.pred_recon_fused(tx, tc, combine, eps=teps)
    for m in range(len(dims)):
        dev_ref = np.asarray(jmodel.reconstruction_deviation(jx[m], ref[m]))
        for port in (plain[m], fused[m]):
            np.testing.assert_allclose(port[0].numpy(), np.asarray(ref[m]),
                                       **TOL)
            np.testing.assert_allclose(port[0].numpy(),
                                       np.asarray(ref_fused[m]), **TOL)
        port_dev = model.reconstruction_deviation(tx[m], plain[m])
        for dev in (port_dev, fused_dev[m]):
            np.testing.assert_allclose(dev[0].numpy(), dev_ref, **TOL)
            np.testing.assert_allclose(dev[0].numpy(),
                                       np.asarray(ref_fused_dev[m]), **TOL)


@pytest.mark.parametrize("combine", ["poe", "gPoE", "moe", "mopoe"])
def test_pred_recon_matches_jax_flagship(combine):
    _check_against_jax(DIMS, combine)


@pytest.mark.parametrize("combine", ["gPoE", "poe"])
def test_pred_recon_matches_jax_single_modality(combine):
    _check_against_jax([270], combine)


def test_pred_recon_matches_jax_three_hidden_layers():
    _check_against_jax([90, 270], "gPoE", b=33, hidden=[64, 110, 32])


def test_latent_stats_matches_jax():
    jmodel, tree = _jax_model(DIMS)
    model = _port(DIMS, tree)
    xes, c = _inputs(DIMS, 20, seed=3)
    mu_ref, var_ref = jmodel.latent_stats(
        tree, [jnp.asarray(x) for x in xes], [jnp.asarray(c)] * 4, "gpoe")
    with torch.no_grad():
        mu, var = model.latent_stats([torch.from_numpy(x[None]) for x in xes],
                                     [torch.from_numpy(c[None])] * 4, "gpoe")
    np.testing.assert_allclose(mu[0].numpy(), np.asarray(mu_ref), **TOL)
    np.testing.assert_allclose(var[0].numpy(), np.asarray(var_ref), **TOL)


def test_fold_stacked_model_scores_each_fold_like_jax():
    """One fold-stacked call equals each fold's own JAX pred_recon."""
    dims = [90, 270]
    fold_models = [_jax_model(dims, seed=s) for s in range(2)]
    model = _port(dims, stack_params([t for _, t in fold_models]), folds=2)
    xes, c = _inputs(dims, 16, seed=5)
    keys = [jax.random.PRNGKey(1000 + f) for f in range(2)]
    eps = np.stack([np.asarray(jax.random.normal(k, (16, Z))) for k in keys])
    tx = [torch.from_numpy(np.stack([x, x + 1.0])) for x in xes]
    tc = [torch.from_numpy(np.stack([c, c]))] * 2
    recons, _ = model.pred_recon_fused(tx, tc, "gpoe",
                                       eps=torch.from_numpy(eps))
    for f, (jmodel, tree) in enumerate(fold_models):
        ref = jmodel.pred_recon(
            tree, [jnp.asarray(x + f) for x in xes], [jnp.asarray(c)] * 2,
            keys[f], "gpoe")
        for m in range(2):
            np.testing.assert_allclose(recons[m][f].numpy(),
                                       np.asarray(ref[m]), **TOL)


def test_reparameterize_draws_from_generator_or_takes_eps():
    mu = torch.zeros(2, 5, 3)
    logvar = torch.full((2, 5, 3), 2.0)
    a = reparameterize(mu, logvar, generator=torch.Generator().manual_seed(1))
    b = reparameterize(mu, logvar, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    eps = torch.ones(2, 5, 3)
    assert torch.allclose(reparameterize(mu, logvar, eps=eps),
                          torch.full((2, 5, 3), float(np.exp(1.0))))


def test_seeded_init_is_reproducible():
    def make():
        return build_model("cVAE_multimodal", [9, 7], [5], 3, 4, 2, folds=2,
                           generator=torch.Generator().manual_seed(0))
    a, b = make(), make()
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert a.alpha.shape == (2, 2)


@pytest.mark.parametrize("name", ["mmJSD", "mvtCAE", "DMVAE",
                                  "WeightedDMVAE", "mmVAEPlus"])
def test_unported_models_point_to_roadmap(name):
    """The five registry names that once raised, pointing to ROADMAP.md,
    are ported: each builds, fold-stacked, and runs a forward and a loss
    (tests/test_torch_zoo.py holds them to the JAX package)."""
    model = build_model(name, [9, 7], [5, 5], 6, 4, 2, folds=2,
                        generator=torch.Generator().manual_seed(0))
    assert model.folds == 2 and model.log_keys[:3] == ("total", "kl", "ll")
    xes = [torch.rand(2, 3, d) for d in (9, 7)]
    fwd = model(xes, [torch.rand(2, 3, 4)] * 2, "poe",
                eps=torch.zeros(2, 3, model.noise_dim))
    losses = model.loss(xes, fwd, torch.ones(2, 3))
    assert tuple(losses) == model.log_keys
    assert all(v.shape == (2,) and torch.isfinite(v).all()
               for v in losses.values())


def test_unknown_model_and_variant_raise():
    with pytest.raises(ValueError, match="not recognized"):
        build_model("nope", [9], [5], 3, 4, 1)
    with pytest.raises(ValueError, match="variant 'nope'"):
        MultimodalCVAE([9], [5], 3, 4, 1, variant="nope")
    # a variant that once raised builds now
    assert MultimodalCVAE([9], [5], 3, 4, 1, variant="mmjsd").log_keys == (
        "total", "kl", "ll", "jsd")
