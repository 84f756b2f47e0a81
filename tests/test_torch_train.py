"""The port's training stage against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and go to both packages; the JAX
init reaches the port through ``params_from_jax``, and the port replays the
JAX noise stream (a per-epoch key split, then a per-step split that does not
advance on an all-padding batch, train/trainer.py:309-352). The JAX
``decoder_nll`` runs its Pallas kernels in interpret mode.

Tolerances are the JAX package's own: loss terms rtol 1e-5; decoder_nll
gradients rtol 1e-4 / atol 1e-6 at small width and rtol 1e-3 / atol 1e-5 at
D = 3485 (tests/test_decoder_nll.py:43-47, :73-77); whole-model gradients
rtol 1e-3 / atol 1e-5 (:105-108); trajectories logs rtol 1e-4 and
parameters rtol 5e-3 / atol 1e-5 (:129-133).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_normative_modeling_tpu.data.loading import (
    generate_kfold_ids as jax_generate_kfold_ids,
)
from multi_modal_normative_modeling_tpu.kernels.decoder_nll import (
    decoder_nll as jax_decoder_nll,
    fused_decoder_loss_fn as jax_fused_loss,
)
from multi_modal_normative_modeling_tpu.models import build_model as jax_build
from multi_modal_normative_modeling_tpu.ops import losses as jlosses
from multi_modal_normative_modeling_tpu.parallel import (
    MultiFoldTrainer as JaxMultiFoldTrainer,
    stack_fold_batches as jax_stack_fold_batches,
    stack_params as jax_stack_params,
)
from multi_modal_normative_modeling_tpu.train import TrainConfig as JaxConfig
from multi_modal_normative_modeling_tpu.train.checkpoints import (
    load_checkpoint as jax_load_checkpoint,
    save_checkpoint as jax_save_checkpoint,
)
from multi_modal_normative_modeling_tpu.train.schedules import (
    cyclic_triangular as jax_cyclic,
)
from multi_modal_normative_modeling_tpu.train.trainer import (
    default_loss_fn as jax_default_loss,
    make_batches as jax_make_batches,
)
from multi_modal_normative_modeling_tpu_torch.cli import common
from multi_modal_normative_modeling_tpu_torch.interop import (
    params_from_jax,
    params_to_jax,
    read_flax_checkpoint,
)
from multi_modal_normative_modeling_tpu_torch.kernels.decoder_nll import (
    decoder_nll,
    fused_decoder_loss_fn,
)
from multi_modal_normative_modeling_tpu_torch.models import build_model
from multi_modal_normative_modeling_tpu_torch.ops import losses
from multi_modal_normative_modeling_tpu_torch.parallel import (
    MultiFoldTrainer,
    stack_fold_batches,
    unstack_params,
)
from multi_modal_normative_modeling_tpu_torch.train import (
    TrainConfig,
    default_loss_fn,
    save_checkpoint,
)
from multi_modal_normative_modeling_tpu_torch.train.schedules import (
    cyclic_triangular,
)
from multi_modal_normative_modeling_tpu_torch.train.trainer import (
    MaskedAdam,
    build_lr_fn,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

DIMS = [24, 40, 16]
HIDDEN = [12, 12]
Z, C = 6, 5


def jax_eps_replay(valid: np.ndarray, epochs: int, rows: int, z_dim: int,
                   key=None) -> np.ndarray:
    """The noise JAX MultiFoldTrainer draws at every step, [epochs * NB, F,
    rows, Z], for per-fold batch validity ``valid`` [F, NB], every fold
    starting from ``key`` (PRNGKey(42), as the CLI)."""
    key = jax.random.PRNGKey(42) if key is None else key
    folds, nb = valid.shape
    eps = np.zeros((epochs * nb, folds, rows, z_dim), np.float32)
    for f in range(folds):
        k = key
        for epoch in range(epochs):
            k, _ = jax.random.split(k)
            for step in range(nb):
                new_k, sub = jax.random.split(k)
                eps[epoch * nb + step, f] = np.asarray(
                    jax.random.normal(sub, (rows, z_dim)))
                if valid[f, step]:
                    k = new_k
    return eps


def _tree(seed=0, dims=DIMS):
    model = jax_build("cVAE_multimodal", dims, HIDDEN, Z, C, len(dims))
    return model, jax.tree_util.tree_map(
        np.asarray, model.init_params(jax.random.PRNGKey(seed)))


def _port(tree, folds, dims=DIMS):
    model = build_model("cVAE_multimodal", dims, HIDDEN, Z, C, len(dims),
                        folds=folds)
    return params_from_jax(jax_stack_params([tree] * folds), model)


def _cohort(rng, n, dims=DIMS):
    data = [rng.standard_normal((n, d)).astype(np.float32) for d in dims]
    return data, [rng.standard_normal((n, C)).astype(np.float32)] * len(dims)


def _close_trees(got, ref, **tol):
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


# ---- loss terms ------------------------------------------------------------

MASKS = {"none": None, "ragged": [1] * 17 + [0] * 3,
         "all padding": [0] * 20}


@pytest.mark.parametrize("mask", MASKS, ids=list(MASKS))
def test_loss_terms_match_jax(mask):
    rng = np.random.default_rng(1)
    mu, lv = (rng.standard_normal((2, 20, Z)).astype(np.float32)
              for _ in range(2))
    x, mean = (rng.standard_normal((2, 20, 37)).astype(np.float32)
               for _ in range(2))
    lvo = rng.standard_normal((2, 1, 37)).astype(np.float32) - 3.0
    m = None if MASKS[mask] is None else np.array(
        [MASKS[mask], [1] * 20], np.float32)
    tm = None if m is None else torch.from_numpy(m)
    kl = losses.kl_standard_normal(torch.from_numpy(mu), torch.from_numpy(lv),
                                   tm)
    ll = losses.gaussian_ll(torch.from_numpy(x), torch.from_numpy(mean),
                            torch.from_numpy(lvo), tm)
    for f in range(2):
        jm = None if m is None else jnp.asarray(m[f])
        np.testing.assert_allclose(
            kl[f].item(), float(jlosses.kl_standard_normal(mu[f], lv[f], jm)),
            rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            ll[f].item(),
            float(jlosses.gaussian_ll(x[f], mean[f], lvo[f], jm)),
            rtol=1e-5, atol=1e-6)


# ---- decoder_nll -------------------------------------------------------------

@pytest.mark.parametrize("b,h,d,pad,tol", [
    (20, 11, 37, 3, dict(rtol=1e-4, atol=1e-6)),
    (16, 110, 3485, 2, dict(rtol=1e-3, atol=1e-5)),
])
def test_decoder_nll_value_and_grads_match_jax(b, h, d, pad, tol):
    """The port's decoder_nll on CPU tensors (the plain version, autograd)
    against JAX decoder_nll under value_and_grad, two folds at once."""
    rng = np.random.default_rng(d)
    folds = 2
    g = rng.standard_normal((folds, b, h)).astype(np.float32)
    w = (rng.standard_normal((folds, h, d)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal((folds, d)) * 0.1).astype(np.float32)
    lvo = np.full((folds, 1, d), -3.0, np.float32)
    x = rng.standard_normal((folds, b, d)).astype(np.float32)
    mask = np.ones((folds, b), np.float32)
    mask[0, b - pad:] = 0.0
    n = np.maximum(mask.sum(-1), 1.0)

    tg, tw, tb, tl = (torch.tensor(a, requires_grad=True) for a in (
        g, np.swapaxes(w, 1, 2).copy(), bias, lvo))
    ll = decoder_nll(tg, tw, tb, tl, torch.from_numpy(x),
                     torch.from_numpy(mask), torch.from_numpy(n))
    grads = torch.autograd.grad(ll.sum(), (tg, tw, tb, tl))
    for f in range(folds):
        def fn(g_, w_, b_, lvo_, f=f):
            return jax_decoder_nll(g_, w_, b_, lvo_, x[f], mask[f], n[f],
                                   tile_b=8, interpret=True)
        val, ref = jax.value_and_grad(fn, argnums=(0, 1, 2, 3))(
            g[f], w[f], bias[f], lvo[f])
        np.testing.assert_allclose(ll[f].item(), float(val), rtol=1e-5)
        got = (grads[0][f], grads[1][f].T, grads[2][f], grads[3][f])
        for a, r in zip(got, ref):
            np.testing.assert_allclose(a.numpy(),
                                       np.asarray(r).reshape(a.shape), **tol)


@pytest.mark.parametrize("combine", ["gpoe", "moe"])
@pytest.mark.parametrize("loss", ["default", "fused_decoder"])
def test_loss_and_grads_match_jax(combine, loss):
    """Loss terms and every gradient of the port's default and
    --fused_decoder losses against JAX's, same params and eps, on a ragged
    batch, two folds (the second all padding but two rows)."""
    jmodel, tree = _tree()
    config = JaxConfig(epochs=1, batch_size=16, combine=combine)
    jax_fn = (jax_default_loss if loss == "default" else jax_fused_loss)(
        jmodel, config)
    model = _port(tree, folds=2)
    port_fn = (default_loss_fn if loss == "default" else
               fused_decoder_loss_fn)(
        model, TrainConfig(epochs=1, batch_size=16, combine=combine))

    rng = np.random.default_rng(2)
    data, cov = _cohort(rng, 20)
    batch = jax.tree_util.tree_map(lambda a: a[1],
                                   jax_make_batches(data, cov, 16))
    mask2 = np.zeros(16, np.float32)
    mask2[:2] = 1.0
    keys = [jax.random.PRNGKey(7), jax.random.PRNGKey(8)]
    eps = np.stack([np.asarray(jax.random.normal(k, (16, Z))) for k in keys])
    masks = np.stack([batch["mask"], mask2])

    tbatch = {"x": [torch.from_numpy(np.stack([x, x])) for x in batch["x"]],
              "c": [torch.from_numpy(np.stack([c, c])) for c in batch["c"]],
              "mask": torch.from_numpy(masks)}
    total, aux = port_fn(tbatch, torch.from_numpy(eps))
    params = list(model.parameters())
    grads = torch.autograd.grad(total.sum(), params, allow_unused=True)
    # the gradients, loaded as the weights of a model of the same shape
    grad_model = _port(tree, folds=2)
    grad_model.load_state_dict({
        name: torch.zeros_like(p) if gr is None else gr
        for (name, p), gr in zip(model.named_parameters(), grads)})
    for f in range(2):
        fold_batch = dict(batch, mask=masks[f])
        (_, ref_aux), ref_grads = jax.jit(jax.value_and_grad(
            jax_fn, has_aux=True))(tree, fold_batch, keys[f])
        for k in ("total", "kl", "ll"):
            np.testing.assert_allclose(aux[k][f].item(), float(ref_aux[k]),
                                       rtol=1e-5)
        got = params_to_jax(grad_model, fold=f)
        _close_trees(got, ref_grads, rtol=1e-3, atol=1e-5)


# ---- the trainer -------------------------------------------------------------

@pytest.mark.parametrize("loss,schedule", [("default", "constant"),
                                           ("fused_decoder", "constant"),
                                           ("default", "cyclic")])
def test_fold_parallel_trajectory_matches_jax(loss, schedule):
    """Two folds of different sizes (the small one gets an all-padding
    batch) train 4 epochs in the port and in JAX MultiFoldTrainer from the
    same init and the same noise."""
    jmodel, tree = _tree()
    rng = np.random.default_rng(3)
    cohorts = [_cohort(rng, 37), _cohort(rng, 21)]
    epochs, bs = 4, 16
    jconfig = JaxConfig(epochs=epochs, batch_size=bs, combine="gpoe",
                        lr_schedule=schedule)
    jbatches = jax_stack_fold_batches([c[0] for c in cohorts],
                                      [c[1] for c in cohorts], bs)
    jtrainer = JaxMultiFoldTrainer(
        jmodel, jconfig, 37,
        loss_fn=jax_fused_loss(jmodel, jconfig) if loss != "default" else None)
    key = jax.random.PRNGKey(42)
    ref_params, ref_logs = jtrainer.run(jax_stack_params([tree, tree]),
                                        jax.device_put(jbatches),
                                        jnp.stack([key, key]))

    model = _port(tree, folds=2)
    config = TrainConfig(epochs=epochs, batch_size=bs, combine="gpoe",
                         lr_schedule=schedule)
    trainer = MultiFoldTrainer(
        model, config, 37,
        loss_fn=fused_decoder_loss_fn(model, config)
        if loss != "default" else None)
    batches = stack_fold_batches([c[0] for c in cohorts],
                                 [c[1] for c in cohorts], bs)
    assert not batches["valid"][1, -1]
    logs = trainer.run(batches,
                       eps=jax_eps_replay(batches["valid"], epochs, bs, Z))
    for k in ("total", "kl", "ll"):
        assert logs[k].shape == (2, epochs)
        np.testing.assert_allclose(logs[k], np.asarray(ref_logs[k]),
                                   rtol=1e-4)
    _close_trees(params_to_jax(model), ref_params, rtol=5e-3, atol=1e-5)


def test_stack_fold_batches_matches_jax():
    rng = np.random.default_rng(4)
    cohorts = [_cohort(rng, 37), _cohort(rng, 9)]
    got = stack_fold_batches([c[0] for c in cohorts], [c[1] for c in cohorts],
                             16)
    ref = jax_stack_fold_batches([c[0] for c in cohorts],
                                 [c[1] for c in cohorts], 16)
    assert got["valid"].tolist() == [[True] * 3, [True, False, False]]
    _close_trees(got, ref, rtol=0, atol=0)


def test_unstack_params_inverts_stacking():
    _, tree = _tree()
    stacked = jax_stack_params([tree, jax.tree_util.tree_map(
        lambda a: a + 1, tree)])
    first, second = unstack_params(stacked, 2)
    _close_trees(first, tree, rtol=0, atol=0)
    _close_trees(second, jax.tree_util.tree_map(lambda a: a + 1, tree),
                 rtol=0, atol=0)


def test_masked_adam_skips_invalid_folds():
    """An invalid fold's params, moments and count stay put; the valid fold
    takes optax.adam's first step, -lr * sign(g) up to eps."""
    p = torch.nn.Parameter(torch.ones(2, 3, 4))
    q = torch.nn.Parameter(torch.zeros(2, 5))
    adam = MaskedAdam([p, q], build_lr_fn(TrainConfig(), 100))
    before = p.detach().clone()
    grads = [torch.full((2, 3, 4), 0.5), None]
    adam.step(grads, torch.tensor([0.0, 1.0]))
    assert torch.equal(p[0], before[0])
    torch.testing.assert_close(p[1], before[1] - 1e-4, rtol=0, atol=1e-7)
    assert torch.equal(q, torch.zeros(2, 5))
    assert adam.count.tolist() == [0.0, 1.0]
    m = adam.m[:24].view(2, 3, 4)
    assert torch.equal(m[0], torch.zeros(3, 4))
    torch.testing.assert_close(m[1], torch.full((3, 4), 0.05))
    # the parameters are views of the optimizer's flat buffer
    adam.step(grads, torch.tensor([1.0, 0.0]))
    assert adam.count.tolist() == [1.0, 1.0]
    torch.testing.assert_close(p[0], before[0] - 1e-4, rtol=0, atol=1e-7)


def test_cyclic_schedule_matches_jax():
    count = np.arange(0, 40, dtype=np.int32)
    ref = np.asarray(jax_cyclic(1e-4, 5e-3, 4.0)(jnp.asarray(count)))
    got = cyclic_triangular(1e-4, 5e-3, 4.0)(torch.from_numpy(count))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)


# ---- checkpoints and fold ids -------------------------------------------------

def test_save_checkpoint_is_read_by_jax_and_the_port(tmp_path):
    jmodel, tree = _tree()
    model = _port(tree, folds=2)
    config = {"model": "cVAE_multimodal", "input_dim_list": DIMS,
              "hidden_dim": HIDDEN, "latent_dim": Z, "c_dim": C,
              "modalities": 3, "non_linear": True, "combine": "gpoe"}
    save_checkpoint(tmp_path / "port", params_to_jax(model, fold=1), config)
    jax_save_checkpoint(tmp_path / "jax", tree, config)
    assert ((tmp_path / "port" / "cVAE_model.ckpt").read_bytes()
            == (tmp_path / "jax" / "cVAE_model.ckpt").read_bytes())
    template = jax.tree_util.tree_map(np.zeros_like, tree)
    restored, got_config = jax_load_checkpoint(tmp_path / "port", template)
    assert got_config == config
    _close_trees(restored, tree, rtol=0, atol=0)
    port_tree, _ = read_flax_checkpoint(tmp_path / "port")
    _close_trees(port_tree, tree, rtol=0, atol=0)
    assert not list((tmp_path / "port").glob(".*.tmp"))


@pytest.mark.parametrize("n,k", [(10, 2), (61, 5), (7, 7)])
def test_kfold_split_matches_sklearn(n, k):
    from sklearn.model_selection import KFold

    ref = list(KFold(n_splits=k, shuffle=True, random_state=42).split(
        np.zeros(n)))
    got = list(common.kfold_split(n, k))
    assert len(got) == k
    for (gt, gs), (rt, rs) in zip(got, ref):
        np.testing.assert_array_equal(gt, rt)
        np.testing.assert_array_equal(gs, rs)


def test_generate_kfold_ids_writes_the_jax_files(tmp_path):
    import pandas as pd

    ids = pd.DataFrame({"IID": [f"s{i}" for i in range(23)],
                        "DIA": [2] * 15 + [0] * 8})
    groups = ids[ids.DIA == 2], ids[ids.DIA != 2]
    for name, fn in (("port", common.generate_kfold_ids),
                     ("jax", jax_generate_kfold_ids)):
        np.random.seed(42)
        fn(*groups, oversample_percentage=1, n_splits=3,
           project_root=tmp_path / name)
    for f in range(3):
        for kind in ("train", "test"):
            rel = f"outputs/kfold_analysis/{kind}_ids_{f:03d}.csv"
            assert ((tmp_path / "port" / rel).read_bytes()
                    == (tmp_path / "jax" / rel).read_bytes())
