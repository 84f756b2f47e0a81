"""The port's packed-modality model against the JAX package's, on the CPU.

The same numpy-seeded inputs and the same reparameterization noise go to JAX
``StackedMultimodalCVAE`` (one fold at a time) and to the port's
fold-stacked one (every fold at once). Bounds are tests/test_stacked.py's:
losses rtol 1e-5 / atol 1e-6, reconstruction means rtol 1e-4 / atol 1e-5,
gradients rtol 5e-4 / atol 1e-5; packing is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_normative_modeling_tpu.models import build_model as jax_build
from multi_modal_normative_modeling_tpu.models.stacked import (
    StackedMultimodalCVAE as JaxStacked,
)
from multi_modal_normative_modeling_tpu_torch.interop import (
    packed_from_jax,
    packed_from_model,
    packed_to_jax,
    packed_to_model,
    params_from_jax,
    params_to_jax,
)
from multi_modal_normative_modeling_tpu_torch.models import build_model
from multi_modal_normative_modeling_tpu_torch.models.stacked import (
    StackedMultimodalCVAE,
)
from multi_modal_normative_modeling_tpu_torch.parallel import stack_params
from tests.test_torch_threads import one_torch_thread  # noqa: F401

DIMS = [24, 40, 16]
C, Z, B = 5, 6, 9
FOLDS = 2

CASES = {
    "poe": ([12, 12], DIMS, "poe"),
    "gpoe": ([12, 12], DIMS, "gpoe"),
    "moe": ([12, 12], DIMS, "moe"),
    "mopoe": ([12, 12], DIMS, "mopoe"),
    "1hidden": ([14], DIMS, "gpoe"),
    "3hidden": ([20, 12, 8], DIMS, "mopoe"),
    "1modality": ([12, 12], [30], "gpoe"),
}


def _trees(hidden, dims):
    """Two folds' JAX init trees (different seeds)."""
    model = jax_build("cVAE_multimodal", dims, hidden, Z, C, len(dims))
    return [jax.tree_util.tree_map(
        np.asarray, model.init_params(jax.random.PRNGKey(seed)))
        for seed in range(FOLDS)]


def _leaves_equal(got, ref):
    got_leaves = jax.tree_util.tree_leaves(got)
    ref_leaves = jax.tree_util.tree_leaves(ref)
    assert len(got_leaves) == len(ref_leaves)
    for a, b in zip(got_leaves, ref_leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("case", ["gpoe", "1hidden", "3hidden", "1modality"])
def test_pack_params_matches_jax_and_round_trips(case):
    hidden, dims, _ = CASES[case]
    trees = _trees(hidden, dims)
    stacked = StackedMultimodalCVAE(dims, hidden, Z, C, len(dims))
    jstacked = JaxStacked(dims, hidden, Z, C, len(dims))
    packed = packed_from_jax(trees, stacked)
    for f, tree in enumerate(trees):
        ref = jax.tree_util.tree_map(np.asarray, jstacked.pack_params(tree))
        got = jax.tree_util.tree_map(lambda t, f=f: t[f].numpy(), packed)
        _leaves_equal(got, ref)
        _leaves_equal(packed_to_jax(packed, stacked, fold=f), tree)


def test_packed_module_round_trip():
    trees = _trees([12, 12], DIMS)
    model = build_model("cVAE_multimodal", DIMS, [12, 12], Z, C, len(DIMS),
                        folds=FOLDS)
    params_from_jax(stack_params(trees), model)
    stacked = StackedMultimodalCVAE(DIMS, [12, 12], Z, C, len(DIMS))
    packed = packed_from_model(model, stacked)
    _leaves_equal(packed, packed_from_jax(trees, stacked))
    other = build_model("cVAE_multimodal", DIMS, [12, 12], Z, C, len(DIMS),
                        folds=FOLDS)
    packed_to_model(packed, stacked, other)
    _leaves_equal(params_to_jax(other), params_to_jax(model))


def _problem(dims, seed=0):
    rng = np.random.default_rng(seed)
    xes = [rng.standard_normal((FOLDS, B, d)).astype(np.float32)
           for d in dims]
    c = rng.standard_normal((FOLDS, B, C)).astype(np.float32)
    eps = rng.standard_normal((FOLDS, B, Z)).astype(np.float32)
    mask = np.ones((FOLDS, B), np.float32)
    mask[0, B - 2:] = 0.0
    return xes, c, eps, mask


def _jax_fold(jstacked, packed, x_packed, c, eps, mask, combine):
    """The JAX stacked model's forward with given noise, then its loss."""
    from multi_modal_normative_modeling_tpu.models import stacked as jmod

    def run(p):
        real = jmod.reparameterize
        jmod.reparameterize = lambda key, mu, lv: mu + eps * jnp.exp(0.5 * lv)
        try:
            fwd = jstacked.forward(p, x_packed, c, None, combine)
        finally:
            jmod.reparameterize = real
        return jstacked.loss(p, x_packed, fwd, mask), fwd

    return run


@pytest.mark.parametrize("case", list(CASES))
def test_forward_loss_and_grads_match_jax(case):
    hidden, dims, combine = CASES[case]
    trees = _trees(hidden, dims)
    stacked = StackedMultimodalCVAE(dims, hidden, Z, C, len(dims))
    jstacked = JaxStacked(dims, hidden, Z, C, len(dims))
    xes, c, eps, mask = _problem(dims)

    packed = packed_from_jax(trees, stacked)
    leaves, treedef = jax.tree_util.tree_flatten(packed)
    leaves = [t.requires_grad_() for t in leaves]
    packed = jax.tree_util.tree_unflatten(treedef, leaves)
    x_packed = stacked.pack_inputs(xes)
    fwd = stacked.forward(packed, x_packed, torch.from_numpy(c), combine,
                          torch.from_numpy(eps))
    loss = stacked.loss(packed, x_packed, fwd, torch.from_numpy(mask))
    grads = torch.autograd.grad(loss["total"].sum(), leaves,
                                allow_unused=True)  # alpha outside gpoe
    grads = jax.tree_util.tree_unflatten(treedef, [
        torch.zeros_like(t) if g is None else g
        for t, g in zip(leaves, grads)])

    for f, tree in enumerate(trees):
        jpacked = jstacked.pack_params(tree)
        xp = jnp.asarray(jstacked.pack_inputs([x[f] for x in xes]))
        run = _jax_fold(jstacked, jpacked, xp, jnp.asarray(c[f]),
                        jnp.asarray(eps[f]), jnp.asarray(mask[f]), combine)
        (ref_loss, ref_fwd) = run(jpacked)
        for k in ("total", "kl", "ll"):
            np.testing.assert_allclose(loss[k][f].item(), float(ref_loss[k]),
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            fwd["recon_means"][f].detach().numpy(),
            np.asarray(ref_fwd["recon_means"]), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(
            fwd["mu_multimodal"][f].detach().numpy(),
            np.asarray(ref_fwd["mu_multimodal"]), rtol=1e-4, atol=1e-5)
        ref_grads = jax.grad(lambda p: run(p)[0]["total"])(jpacked)
        got = jax.tree_util.tree_map(lambda t, f=f: t[f].numpy(), grads)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(ref_grads)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=5e-4,
                                       atol=1e-5)
    # padded weight rows (modality 0's x block past its width) get exactly
    # zero gradient
    if len(dims) > 1:
        pad = grads["enc"]["layers"][0]["w"][:, 0, dims[0]:stacked.d_max]
        assert torch.count_nonzero(pad) == 0
        assert torch.count_nonzero(
            grads["dec"]["lvo"][:, 2, dims[2]:]) == 0


@pytest.mark.parametrize("variant", ["mmjsd", "mvtcae", "nmmlp"])
def test_other_variants_raise(variant):
    with pytest.raises(NotImplementedError, match="queue 1 item 'Zoo'"):
        StackedMultimodalCVAE(DIMS, [12], Z, C, 3, variant=variant)
