"""The port's model zoo against the JAX package's, on the CPU.

mmJSD, mvtCAE and the nm-MLP variant of the cVAE skeleton, and the DMVAE
family (DMVAE, WeightedDMVAE, mmVAEPlus), each with the JAX ``init_params``
tree carried across by ``params_from_jax`` and the JAX noise replayed
(``jax.random.normal(key, fused_mu.shape)``, what the JAX ``reparameterize``
draws). Inputs come from a numpy seed; two folds with different parameters
and inputs go through the port at once and through JAX one by one.

Tolerances: forward leaves and loss terms rtol 1e-5 / atol 1e-6, gradients of
``total`` rtol 1e-4 / atol 1e-6, the loss-term functions rtol 1e-5 / atol
1e-6 (the bounds tests/test_torch_train.py holds the cvae terms to).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_normative_modeling_tpu.models import build_model as jax_build
from multi_modal_normative_modeling_tpu.models.dmvae import (
    DMVAEFamily as JaxDMVAEFamily,
)
from multi_modal_normative_modeling_tpu.models.multimodal import (
    MultimodalCVAE as JaxMultimodalCVAE,
    total_correlation as jax_total_correlation,
)
from multi_modal_normative_modeling_tpu.ops import (
    fusion as jfusion,
    losses as jlosses,
)
from multi_modal_normative_modeling_tpu.train.checkpoints import (
    load_checkpoint as jax_load_checkpoint,
    save_checkpoint as jax_save_checkpoint,
)
from multi_modal_normative_modeling_tpu_torch.interop import (
    params_from_jax,
    params_to_jax,
    read_flax_checkpoint,
)
from multi_modal_normative_modeling_tpu_torch.models import (
    DMVAEFamily,
    MultimodalCVAE,
    build_model,
)
from multi_modal_normative_modeling_tpu_torch.models.multimodal import (
    total_correlation,
)
from multi_modal_normative_modeling_tpu_torch.ops import fusion, losses
from multi_modal_normative_modeling_tpu_torch.parallel import stack_params
from multi_modal_normative_modeling_tpu_torch.train import save_checkpoint
from multi_modal_normative_modeling_tpu_torch.train.trainer import FoldNoise
from tests.test_torch_threads import one_torch_thread  # noqa: F401

DIMS = [24, 40, 16]
HIDDEN = [12, 12]
C = 5
B = 20
FOLDS = 2
TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)

# name -> (registry name or skeleton variant, latent dim, combine, extra
# constructor arguments); latent 4 <= C is the DMVAE family's empty shared
# code, latent 9 a real split (shared width 4)
CASES = {
    "mmJSD": ("mmJSD", 6, "poe", {}),
    "mmJSD-gpoe-ignored": ("mmJSD", 6, "gpoe", {}),
    "mmJSD-per-modality-jsd": ("mmjsd", 6, "poe", {"jsd_on_fused": False}),
    "mvtCAE-poe": ("mvtCAE", 6, "poe", {}),
    "mvtCAE-gpoe": ("mvtCAE", 6, "gpoe", {}),
    "nmmlp": ("nmmlp", 6, "gpoe", {}),
    "DMVAE": ("DMVAE", 9, "poe", {}),
    "DMVAE-empty-shared": ("DMVAE", 4, "poe", {}),
    "WeightedDMVAE": ("WeightedDMVAE", 9, "poe", {}),
    "WeightedDMVAE-empty-shared": ("WeightedDMVAE", 4, "poe", {}),
    "mmVAEPlus": ("mmVAEPlus", 9, "poe", {}),
    "mmVAEPlus-empty-shared": ("mmVAEPlus", 4, "poe", {}),
}
REGISTRY_NAMES = ["cVAE_multimodal", "mmJSD", "mvtCAE", "DMVAE",
                  "WeightedDMVAE", "mmVAEPlus"]
MASKS = ["none", "ragged"]


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def make_pair(name, z, extra=None, folds=FOLDS, dims=DIMS, hidden=HIDDEN,
              c_dim=C, seed=0):
    """(JAX model, one JAX init tree per fold, the port's fold-stacked model
    holding them)."""
    extra = extra or {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the empty shared code
        if name in REGISTRY_NAMES:
            jmodel = jax_build(name, dims, hidden, z, c_dim, len(dims))
            model = build_model(name, dims, hidden, z, c_dim, len(dims),
                                folds=folds)
        else:
            jmodel = JaxMultimodalCVAE(dims, hidden, z, c_dim, len(dims),
                                       variant=name, **extra)
            model = MultimodalCVAE(dims, hidden, z, c_dim, len(dims),
                                   variant=name, folds=folds, **extra)
    trees = [numpy_tree(jmodel.init_params(jax.random.PRNGKey(seed + f)))
             for f in range(folds)]
    params_from_jax(stack_params(trees), model)
    return jmodel, trees, model


def make_inputs(seed, rows=B, dims=DIMS, folds=FOLDS, c_dim=C):
    """Per fold: per-modality x [rows, D] and one covariate block."""
    rng = np.random.default_rng(seed)
    xes = [[rng.standard_normal((rows, d)).astype(np.float32) for d in dims]
           for _ in range(folds)]
    cs = [rng.standard_normal((rows, c_dim)).astype(np.float32)
          for _ in range(folds)]
    return xes, cs


def make_masks(kind, rows=B, folds=FOLDS):
    """[F, rows] or None: fold 0 loses its last three rows, the others
    none."""
    if kind == "none":
        return None
    mask = np.ones((folds, rows), np.float32)
    mask[0, rows - 3:] = 0.0
    return mask


def jax_eps(keys, rows, width):
    return np.stack([np.asarray(jax.random.normal(k, (rows, width)))
                     for k in keys]).astype(np.float32)


def stack_folds(xes, cs):
    """The port's inputs: per modality [F, rows, D], and [F, rows, C]."""
    tx = [torch.from_numpy(np.stack([fold[m] for fold in xes]))
          for m in range(len(xes[0]))]
    tc = torch.from_numpy(np.stack(cs))
    return tx, [tc] * len(tx)


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def close_trees(got, ref, **tol):
    got_leaves, got_def = jax.tree_util.tree_flatten(got)
    ref_leaves, ref_def = jax.tree_util.tree_flatten(ref)
    assert got_def == ref_def
    for a, b in zip(got_leaves, ref_leaves):
        close(a, b, **tol)


# ---- forward and loss ------------------------------------------------------------

@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("case", CASES)
def test_forward_and_loss_match_jax(case, mask_kind):
    name, z, combine, extra = CASES[case]
    jmodel, trees, model = make_pair(name, z, extra)
    xes, cs = make_inputs(seed=1)
    masks = make_masks(mask_kind)
    keys = [jax.random.PRNGKey(7 + f) for f in range(FOLDS)]
    eps = jax_eps(keys, B, model.noise_dim)
    assert eps.shape == (FOLDS, B, model.noise_dim)

    tx, tc = stack_folds(xes, cs)
    fwd = model(tx, tc, combine, eps=torch.from_numpy(eps))
    out = model.loss(tx, fwd, None if masks is None
                     else torch.from_numpy(masks))
    assert tuple(out) == model.log_keys
    for f in range(FOLDS):
        jx = [jnp.asarray(x) for x in xes[f]]
        jc = [jnp.asarray(cs[f])] * len(DIMS)
        ref = jmodel.forward(trees[f], jx, jc, keys[f], combine)
        assert set(ref) == set(fwd)
        for key, want in ref.items():
            got = fwd[key]
            if isinstance(want, (list, tuple)):
                assert len(got) == len(want)
                for g, w in zip(got, want):
                    w = np.asarray(w)
                    close(g[f].detach().numpy().reshape(w.shape), w, **TOL)
            elif key in ("mus", "logvars"):     # [M, F, B, Z]
                close(got[:, f].detach().numpy(), want, **TOL)
            else:
                close(got[f].detach().numpy(), want, **TOL)
        ref_loss = jmodel.loss(trees[f], jx, ref,
                               None if masks is None
                               else jnp.asarray(masks[f]))
        assert set(ref_loss) == set(out)
        for key, want in ref_loss.items():
            close(out[key][f].item(), float(want), **TOL)


def test_mmjsd_on_fused_statistics_is_zero_and_per_modality_is_not():
    """The reference's JSD over M copies of the fused statistics is
    identically zero (cVAE.py:1427); the per-modality one is not."""
    xes, cs = make_inputs(seed=2)
    tx, tc = stack_folds(xes, cs)
    eps = torch.zeros(FOLDS, B, 6)
    for on_fused in (True, False):
        _, _, model = make_pair("mmjsd", 6, {"jsd_on_fused": on_fused})
        out = model.loss(tx, model(tx, tc, "poe", eps=eps))
        if on_fused:
            assert torch.equal(out["jsd"], torch.zeros(FOLDS))
        else:
            assert (out["jsd"] > 0).all()


# ---- gradients -------------------------------------------------------------------

@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("case", CASES)
def test_gradients_match_jax(case, mask_kind):
    name, z, combine, extra = CASES[case]
    jmodel, trees, model = make_pair(name, z, extra)
    xes, cs = make_inputs(seed=3)
    masks = make_masks(mask_kind)
    keys = [jax.random.PRNGKey(11 + f) for f in range(FOLDS)]
    eps = jax_eps(keys, B, model.noise_dim)

    tx, tc = stack_folds(xes, cs)
    fwd = model(tx, tc, combine, eps=torch.from_numpy(eps))
    total = model.loss(tx, fwd, None if masks is None
                       else torch.from_numpy(masks))["total"]
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(total.sum(), list(model.parameters()),
                                allow_unused=True)
    # the gradients, loaded as the weights of a model of the same shape
    _, _, grad_model = make_pair(name, z, extra)
    grad_model.load_state_dict({
        k: torch.zeros_like(p) if g is None else g
        for k, p, g in zip(names, model.parameters(), grads)})
    for f in range(FOLDS):
        jx = [jnp.asarray(x) for x in xes[f]]
        jc = [jnp.asarray(cs[f])] * len(DIMS)
        jmask = None if masks is None else jnp.asarray(masks[f])

        def fn(p, jx=jx, jc=jc, f=f, jmask=jmask):
            ref = jmodel.forward(p, jx, jc, keys[f], combine)
            return jmodel.loss(p, jx, ref, jmask)["total"]

        close_trees(params_to_jax(grad_model, fold=f),
                    numpy_tree(jax.grad(fn)(trees[f])), **GRAD_TOL)


# ---- interop, registry, checkpoints ---------------------------------------------

@pytest.mark.parametrize("z", [4, 9], ids=["latent<=c", "latent>c"])
@pytest.mark.parametrize("name", REGISTRY_NAMES + ["nmmlp"])
def test_params_round_trip_through_the_port(name, z):
    _, trees, model = make_pair(name, z, folds=3)
    stacked = stack_params(trees)
    got = params_to_jax(model)
    close_trees(got, stacked, rtol=0, atol=0)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(stacked)):
        assert a.dtype == b.dtype and a.shape == b.shape
    for f in range(3):
        close_trees(params_to_jax(model, fold=f), trees[f], rtol=0, atol=0)


@pytest.mark.parametrize("name,family,variant", [
    ("cVAE_multimodal", MultimodalCVAE, "cvae"),
    ("mmJSD", MultimodalCVAE, "mmjsd"),
    ("mvtCAE", MultimodalCVAE, "mvtcae"),
    ("DMVAE", DMVAEFamily, "dmvae"),
    ("WeightedDMVAE", DMVAEFamily, "weighted"),
    ("mmVAEPlus", DMVAEFamily, "mmvaeplus")])
def test_build_model_builds_the_registry(name, family, variant):
    model = build_model(name, DIMS, HIDDEN, 9, C, 3, folds=2,
                        generator=torch.Generator().manual_seed(0))
    assert type(model) is family and model.variant == variant
    assert model.folds == 2 and model.latent_dim == 9
    skeleton = family is MultimodalCVAE
    assert model.noise_dim == (9 if skeleton else 9 - C)
    assert hasattr(model, "pred_recon_fused") == skeleton
    assert hasattr(model, "latent_stats") == skeleton
    extra = {"mmjsd": ("jsd",), "mvtcae": ("tc",)}.get(variant, ())
    assert model.log_keys == ("total", "kl", "ll") + extra
    assert hasattr(model, "weights") == (variant == "weighted")
    if variant == "weighted":
        assert model.weights.shape == (2, 3) and (model.weights >= 0).all()


def test_unknown_names_raise_the_jax_message():
    with pytest.raises(ValueError) as port_error:
        build_model("nope", DIMS, HIDDEN, 6, C, 3)
    with pytest.raises(ValueError) as jax_error:
        jax_build("nope", DIMS, HIDDEN, 6, C, 3)
    assert str(port_error.value) == str(jax_error.value)
    with pytest.raises(ValueError, match="variant"):
        MultimodalCVAE(DIMS, HIDDEN, 6, C, 3, variant="nope")
    with pytest.raises(ValueError, match="variant"):
        DMVAEFamily(DIMS, HIDDEN, 6, C, 3, variant="nope")


def test_dmvae_family_warns_on_an_empty_shared_code():
    with pytest.warns(UserWarning, match="shared code is empty") as port:
        DMVAEFamily(DIMS, HIDDEN, 4, C, 3)
    with pytest.warns(UserWarning, match="shared code is empty") as ref:
        JaxDMVAEFamily(DIMS, HIDDEN, 4, C, 3)
    assert str(port[0].message) == str(ref[0].message)


@pytest.mark.parametrize("name,z", [("mvtCAE", 6), ("DMVAE", 4),
                                    ("DMVAE", 9), ("WeightedDMVAE", 9),
                                    ("mmVAEPlus", 9)])
def test_checkpoints_cross_both_ways(name, z, tmp_path):
    """The port's writer is byte-equal to flax's for each model's tree, the
    JAX loader restores what the port wrote, and the port's reader restores
    what the JAX package wrote."""
    jmodel, trees, model = make_pair(name, z)
    config = {"model": name, "input_dim_list": DIMS, "hidden_dim": HIDDEN,
              "latent_dim": z, "c_dim": C, "modalities": 3,
              "non_linear": True, "combine": "PoE"}
    save_checkpoint(tmp_path / "port", params_to_jax(model, fold=1), config)
    jax_save_checkpoint(tmp_path / "jax", trees[1], config)
    assert ((tmp_path / "port" / "cVAE_model.ckpt").read_bytes()
            == (tmp_path / "jax" / "cVAE_model.ckpt").read_bytes())
    template = jax.tree_util.tree_map(np.zeros_like, trees[1])
    restored, got_config = jax_load_checkpoint(tmp_path / "port", template)
    assert got_config == config
    close_trees(restored, trees[1], rtol=0, atol=0)
    port_tree, port_config = read_flax_checkpoint(tmp_path / "jax")
    assert port_config == config
    close_trees(port_tree, trees[1], rtol=0, atol=0)


# ---- loss terms and fusion ops ---------------------------------------------------

TERM_MASKS = {"none": None, "ragged": [1] * 17 + [0] * 3,
              "all padding": [0] * 20}


def _term_inputs(width=37):
    rng = np.random.default_rng(1)
    a, b = (rng.standard_normal((2, 20, width)).astype(np.float32)
            for _ in range(2))
    return a, b


@pytest.mark.parametrize("mask", TERM_MASKS, ids=list(TERM_MASKS))
@pytest.mark.parametrize("term", ["neg_half_sse", "neg_mse"])
def test_reconstruction_terms_match_jax(term, mask):
    x, recon = _term_inputs()
    m = None if TERM_MASKS[mask] is None else np.array(
        [TERM_MASKS[mask], [1] * 20], np.float32)
    got = getattr(losses, term)(torch.from_numpy(x), torch.from_numpy(recon),
                                None if m is None else torch.from_numpy(m))
    assert got.shape == (2,)
    for f in range(2):
        want = getattr(jlosses, term)(x[f], recon[f],
                                      None if m is None else jnp.asarray(m[f]))
        close(got[f].item(), float(want), **TOL)


@pytest.mark.parametrize("mask", TERM_MASKS, ids=list(TERM_MASKS))
@pytest.mark.parametrize("experts", [1, 2, 3])
def test_pairwise_jsd_matches_jax(experts, mask):
    rng = np.random.default_rng(experts)
    mus = [rng.standard_normal((2, 20, 6)).astype(np.float32)
           for _ in range(experts)]
    lvs = [(0.3 * rng.standard_normal((2, 20, 6))).astype(np.float32)
           for _ in range(experts)]
    m = None if TERM_MASKS[mask] is None else np.array(
        [TERM_MASKS[mask], [1] * 20], np.float32)
    got = losses.pairwise_jsd([torch.from_numpy(a) for a in mus],
                              [torch.from_numpy(a) for a in lvs],
                              None if m is None else torch.from_numpy(m))
    assert got.shape == (2,)
    for f in range(2):
        want = jlosses.pairwise_jsd([a[f] for a in mus], [a[f] for a in lvs],
                                    None if m is None else jnp.asarray(m[f]))
        close(got[f].item(), float(want), **TOL)


def test_gaussian_kl_pair_matches_jax():
    rng = np.random.default_rng(4)
    args = [rng.standard_normal((2, 9, 5)).astype(np.float32)
            for _ in range(4)]
    got = losses.gaussian_kl_pair(*(torch.from_numpy(a) for a in args))
    close(got.numpy(), jlosses.gaussian_kl_pair(*args), **TOL)
    same = losses.gaussian_kl_pair(*(torch.from_numpy(a)
                                     for a in args[:2] * 2))
    assert torch.equal(same, torch.zeros(2, 9, 5))


@pytest.mark.parametrize("mask", ["none", "ragged"])
def test_total_correlation_matches_jax(mask):
    rng = np.random.default_rng(5)
    mus = rng.standard_normal((3, 2, 20, 6)).astype(np.float32)
    m = None if mask == "none" else np.array(
        [TERM_MASKS["ragged"], [1] * 20], np.float32)
    got = total_correlation(torch.from_numpy(mus),
                            None if m is None else torch.from_numpy(m))
    assert got.shape == (2,)
    for f in range(2):
        want = jax_total_correlation(
            jnp.asarray(mus[:, f]), None if m is None else jnp.asarray(m[f]))
        close(got[f].item(), float(want), **TOL)


def test_total_correlation_of_an_all_padding_fold_is_infinite():
    """What the trainers must drop: the fold without a valid row gives +inf
    (JAX too), the fold beside it stays finite."""
    mus = torch.randn(3, 2, 8, 4, generator=torch.Generator().manual_seed(0))
    mask = torch.tensor([[0.0] * 8, [1.0] * 8])
    got = total_correlation(mus, mask)
    assert got[0].item() == float("inf") and torch.isfinite(got[1])
    want = jax_total_correlation(jnp.asarray(mus[:, 0].numpy()),
                                 jnp.zeros(8))
    assert float(want) == float("inf")


@pytest.mark.parametrize("width", [0, 4], ids=["zero-width", "width 4"])
def test_poe_logvar_on_a_fold_stack(width):
    """[M, F, B, Z] statistics, also with an empty latent axis (the DMVAE
    family's shared code when latent_dim <= c_dim)."""
    rng = np.random.default_rng(6)
    mus, lvs = (rng.standard_normal((3, 2, 7, width)).astype(np.float32)
                for _ in range(2))
    mu, lv = fusion.poe_logvar(torch.from_numpy(mus), torch.from_numpy(lvs))
    assert mu.shape == lv.shape == (2, 7, width)
    for f in range(2):
        ref_mu, ref_lv = jfusion.poe_logvar(jnp.asarray(mus[:, f]),
                                            jnp.asarray(lvs[:, f]))
        close(mu[f].numpy(), ref_mu, **TOL)
        close(lv[f].numpy(), ref_lv, **TOL)
    kl = losses.kl_standard_normal(mu, lv, torch.ones(2, 7))
    assert kl.shape == (2,)
    if width == 0:
        assert torch.equal(kl, torch.zeros(2))


@pytest.mark.parametrize("shortcut", [True, False])
@pytest.mark.parametrize("width", [0, 4], ids=["zero-width", "width 4"])
def test_single_modality_shortcut_on_a_fold_stack(width, shortcut):
    rng = np.random.default_rng(7)
    mus = rng.standard_normal((1, 2, 7, width)).astype(np.float32)
    var = np.exp(rng.standard_normal((1, 2, 7, width))).astype(np.float32)
    alpha = rng.standard_normal((2, 1)).astype(np.float32)
    mu, v = fusion.combine_latent(
        torch.from_numpy(mus), torch.from_numpy(var), "gpoe",
        torch.from_numpy(alpha), single_modality_shortcut=shortcut)
    assert mu.shape == v.shape == (2, 7, width)
    for f in range(2):
        ref_mu, ref_v = jfusion.combine_latent(
            jnp.asarray(mus[:, f]), jnp.asarray(var[:, f]), "gpoe",
            jnp.asarray(alpha[f]), single_modality_shortcut=shortcut)
        close(mu[f].numpy(), ref_mu, **TOL)
        close(v[f].numpy(), ref_v, **TOL)
    if shortcut:
        assert torch.equal(mu, torch.from_numpy(mus[0]))


@pytest.mark.parametrize("width", [0, 3])
def test_fold_noise_draws_any_width(width):
    noise = FoldNoise(2, (5, width), seed=42, device="cpu")
    drawn = noise.draw(np.array([True, False]))
    assert drawn.shape == (2, 5, width)
    assert torch.equal(drawn[1], torch.zeros(5, width))
    again = FoldNoise(2, (5, width), seed=42, device="cpu").draw(
        np.array([True, True]))
    assert torch.equal(again[0], drawn[0]) and torch.equal(again[1], again[0])
