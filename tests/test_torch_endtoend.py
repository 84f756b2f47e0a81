"""The end-to-end nm-PM-cont model of the port against the JAX package's,
on the CPU.

The JAX ``init_params`` tree goes into the port's fold-stacked
``EndToEndCVAE`` through ``params_from_jax`` (the classifier's BatchNorm
running statistics, ``bn_state`` in the JAX tree, become its buffers), and
the JAX draws are replayed: the noise ``normal(z_key)`` and each classifier
block's dropout keep mask ``bernoulli(block_key, 0.5)`` of
``key, z_key, drop_key = split(key, 3)`` (models/endtoend.py:96,
models/cvae.py:161-164). Two folds with different parameters and inputs go
through the port at once and through JAX one by one.

Bounds, those of tests/test_torch_zoo.py: forward leaves and loss terms
rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-6, in train and eval
mode, with and without a ragged row mask. Trajectories, those of
tests/test_torch_train.py: two folds of 37 and 21 subjects in batches of
16 (the small fold meets an all-padding batch every epoch), 4 epochs, logs
rtol 1e-4, parameters and running statistics rtol 5e-3 / atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from multi_modal_normative_modeling_tpu.models.cvae import (
    apply_classifier as jax_apply_classifier,
    init_classifier as jax_init_classifier,
)
from multi_modal_normative_modeling_tpu.models.endtoend import (
    EndToEndCVAE as JaxEndToEnd,
)
from multi_modal_normative_modeling_tpu.ops import losses as jlosses
from multi_modal_normative_modeling_tpu.parallel import (
    MultiFoldTrainer as JaxMultiFoldTrainer,
    stack_fold_batches as jax_stack_fold_batches,
    stack_params as jax_stack_params,
)
from multi_modal_normative_modeling_tpu.train import TrainConfig as JaxConfig
from multi_modal_normative_modeling_tpu_torch.interop import (
    params_from_jax,
    params_to_jax,
)
from multi_modal_normative_modeling_tpu_torch.models import (
    Classifier,
    EndToEndCVAE,
)
from multi_modal_normative_modeling_tpu_torch.models.endtoend import (
    endtoend_loss_fn,
)
from multi_modal_normative_modeling_tpu_torch.ops import losses
from multi_modal_normative_modeling_tpu_torch.parallel import (
    MultiFoldTrainer,
    stack_fold_batches,
    stack_params,
)
from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
from multi_modal_normative_modeling_tpu_torch.train.checkpoints import (
    to_bytes,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

DIMS = [24, 40, 16]
HIDDEN = [12, 12]
Z = 6
C = 5
LAYERS = [16, 8]
B = 20
FOLDS = 2
TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
MARGIN, WEIGHT_CON = 1.0, 0.5


def jax_draws(valid, epochs, rows, z_dim, keep_widths=(), shuffle=False,
              key=None, dtype=np.float32):
    """The draws JAX's trainer makes at every step of a fold that starts
    from ``key`` (PRNGKey(42), as the CLIs), for the port's replay hooks:
    {"eps": [epochs * NB, F, rows, Z]} and, with ``keep_widths`` (the
    end-to-end model: its step key split in three, models/endtoend.py:96),
    "keeps", one [epochs * NB, F, rows, width] per block; with ``shuffle``,
    "perms" [epochs, F, NB * rows], each epoch's permutation of the fold's
    own nb_f * rows grid (train/trainer.py:349-352) with the rows behind it
    in place. ``valid`` [F, NB] is the per-fold batch validity; ``dtype``
    is the noise's (float64 under jax.enable_x64)."""
    key = jax.random.PRNGKey(42) if key is None else key
    folds, nb = valid.shape
    eps = np.zeros((epochs * nb, folds, rows, z_dim), dtype)
    keeps = [np.zeros((epochs * nb, folds, rows, w), bool)
             for w in keep_widths]
    perms = np.tile(np.arange(nb * rows), (epochs, folds, 1))
    for f in range(folds):
        own = int(valid[f].sum()) * rows
        k = key
        for epoch in range(epochs):
            k, shuffle_key = jax.random.split(k)
            if shuffle:
                perms[epoch, f, :own] = np.asarray(
                    jax.random.permutation(shuffle_key, own))
            for step in range(nb):
                new_k, sub = jax.random.split(k)
                t = epoch * nb + step
                if keep_widths:
                    _, z_key, drop_key = jax.random.split(sub, 3)
                    for i, w in enumerate(keep_widths):
                        drop_key, block = jax.random.split(drop_key)
                        keeps[i][t, f] = np.asarray(
                            jax.random.bernoulli(block, 0.5, (rows, w)))
                else:
                    z_key = sub
                eps[t, f] = np.asarray(jax.random.normal(z_key,
                                                         (rows, z_dim)))
                if valid[f, step]:
                    k = new_k
    out = {"eps": eps}
    if keep_widths:
        out["keeps"] = keeps
    if shuffle:
        out["perms"] = perms
    return out


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def make_pair(folds=FOLDS, dims=DIMS, seed=0):
    """(JAX model, one JAX tree per fold with non-trivial running
    statistics, the port's fold-stacked model holding them)."""
    jmodel = JaxEndToEnd(dims, HIDDEN, Z, C, len(dims),
                         classifier_layers=LAYERS)
    rng = np.random.default_rng(seed)
    trees = []
    for f in range(folds):
        tree = numpy_tree(jmodel.init_params(jax.random.PRNGKey(seed + f)))
        for state in tree["bn_state"]:
            state["mean"] = rng.standard_normal(state["mean"].shape).astype(
                np.float32)
            state["var"] = rng.uniform(0.5, 2.0, state["var"].shape).astype(
                np.float32)
        trees.append(tree)
    model = EndToEndCVAE(dims, HIDDEN, Z, C, len(dims),
                         classifier_layers=LAYERS, folds=folds)
    params_from_jax(stack_params(trees), model)
    return jmodel, trees, model


def make_inputs(seed, rows=B, dims=DIMS, folds=FOLDS):
    rng = np.random.default_rng(seed)
    xes = [[rng.standard_normal((rows, d)).astype(np.float32) for d in dims]
           for _ in range(folds)]
    cs = [rng.standard_normal((rows, C)).astype(np.float32)
          for _ in range(folds)]
    labels = [rng.integers(0, 2, rows) for _ in range(folds)]
    return xes, cs, labels


def masks(kind, rows=B, folds=FOLDS):
    if kind == "none":
        return None
    out = np.ones((folds, rows), np.float32)
    out[0, 13:] = 0.0
    out[1, 7:] = 0.0
    return out


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def check_bias_grad(got, want, weight_grad, train):
    """A classifier block's linear bias gradient. In train mode BatchNorm
    subtracts the batch mean right after the linear, so the bias's gradient
    is zero: both sides hold rounding of a zero, held below 1e-5 of the
    block's largest weight gradient; in eval mode it is compared at the
    gradient bound."""
    if train:
        scale = float(np.abs(np.asarray(weight_grad)).max())
        assert np.abs(np.asarray(got)).max() <= 1e-5 * scale
        assert np.abs(np.asarray(want)).max() <= 1e-5 * scale
    else:
        close(got, want, **GRAD_TOL)


def fold_draws(key, rows):
    """One fold's eps and keep masks of one JAX forward from ``key``."""
    _, z_key, drop_key = jax.random.split(key, 3)
    eps = np.asarray(jax.random.normal(z_key, (rows, Z)))
    keeps = []
    for w in LAYERS:
        drop_key, block = jax.random.split(drop_key)
        keeps.append(np.asarray(jax.random.bernoulli(block, 0.5, (rows, w))))
    return eps, keeps


# ---- the two new loss terms ---------------------------------------------------

@pytest.mark.parametrize("mask_kind", ["none", "ragged"])
def test_margin_contrastive_and_cross_entropy_match_jax(mask_kind):
    rng = np.random.default_rng(1)
    dev_h = rng.uniform(0, 2, (FOLDS, B)).astype(np.float32)
    dev_d = rng.uniform(0, 2, (FOLDS, B)).astype(np.float32)
    labels = rng.integers(0, 2, (FOLDS, B))
    logits = rng.standard_normal((FOLDS, B, 3)).astype(np.float32)
    mask = masks(mask_kind)
    con = losses.margin_contrastive(t(dev_h), t(dev_d), t(labels), 0.7,
                                    None if mask is None else t(mask))
    ce = losses.cross_entropy_logits(t(logits), t(labels),
                                     None if mask is None else t(mask))
    assert con.shape == ce.shape == (FOLDS,)
    for f in range(FOLDS):
        m = None if mask is None else mask[f]
        close(con[f], jlosses.margin_contrastive(dev_h[f], dev_d[f],
                                                 labels[f], 0.7, m), **TOL)
        close(ce[f], jlosses.cross_entropy_logits(logits[f], labels[f], m),
              **TOL)


# ---- the classifier head -----------------------------------------------------

@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("mask_kind", ["none", "ragged"])
def test_classifier_head_matches_jax(train, mask_kind):
    """Logits, the running statistics it leaves and the gradients of a
    weighted sum of the logits, against JAX apply_classifier per fold."""
    rng = np.random.default_rng(2)
    head = Classifier(Z, LAYERS, folds=FOLDS)
    trees, states = [], []
    for f in range(FOLDS):
        init = numpy_tree(jax_init_classifier(jax.random.PRNGKey(f), Z,
                                              LAYERS))
        for s in init["state"]:
            s["mean"] = rng.standard_normal(s["mean"].shape).astype(np.float32)
            s["var"] = rng.uniform(0.5, 2, s["var"].shape).astype(np.float32)
        trees.append(init["params"])
        states.append(init["state"])
    params_from_jax({"classifier": stack_params(trees),
                     "bn_state": stack_params(states)},
                    torch.nn.ModuleDict({"classifier": head}))
    z = rng.standard_normal((FOLDS, B, Z)).astype(np.float32)
    weights = rng.standard_normal((FOLDS, B, 2)).astype(np.float32)
    mask = masks(mask_kind)
    keys = [jax.random.PRNGKey(10 + f) for f in range(FOLDS)]
    keeps = []
    for key in keys:
        fold_keeps = []
        for w in LAYERS:
            key, block = jax.random.split(key)
            fold_keeps.append(np.asarray(
                jax.random.bernoulli(block, 0.5, (B, w))))
        keeps.append(fold_keeps)

    logits, new_state = head(
        t(z), train, None if mask is None else t(mask),
        keep=[t(np.stack([k[i] for k in keeps])) for i in range(len(LAYERS))])
    (logits * t(weights)).sum().backward()
    for f in range(FOLDS):
        m = None if mask is None else mask[f]

        def objective(p, f=f, m=m):
            out, state = jax_apply_classifier(p, states[f], z[f], keys[f],
                                              0.5, train, m)
            return jnp.sum(out * weights[f]), (out, state)

        (_, (ref, ref_state)), ref_grads = jax.value_and_grad(
            objective, has_aux=True)(trees[f])
        close(logits[f].detach(), ref, **TOL)
        for (mean, var), s in zip(new_state, ref_state):
            close(mean[f], s["mean"], **TOL)
            close(var[f], s["var"], **TOL)
        for block, ref_block in zip(head.blocks, ref_grads["blocks"]):
            close(block.linear.weight.grad[f].T, ref_block["linear"]["w"],
                  **GRAD_TOL)
            check_bias_grad(block.linear.bias.grad[f],
                            ref_block["linear"]["b"],
                            block.linear.weight.grad[f], train)
            close(block.bn_scale.grad[f], ref_block["bn_scale"], **GRAD_TOL)
            close(block.bn_bias.grad[f], ref_block["bn_bias"], **GRAD_TOL)
        close(head.out.weight.grad[f].T, ref_grads["out"]["w"], **GRAD_TOL)
    # the buffers move only through update_state, and only for valid folds
    before = [s.mean.clone() for s in head.state]
    head.update_state(new_state, torch.tensor([1.0, 0.0]))
    for s, old, (mean, _) in zip(head.state, before, new_state):
        assert torch.equal(s.mean[0], mean[0])
        assert torch.equal(s.mean[1], old[1])


# ---- the whole model -----------------------------------------------------------

@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("mask_kind", ["none", "ragged"])
def test_forward_loss_and_gradients_match_jax(train, mask_kind):
    jmodel, trees, model = make_pair()
    xes, cs, labels = make_inputs(3)
    mask = masks(mask_kind)
    keys = [jax.random.PRNGKey(20 + f) for f in range(FOLDS)]
    draws = [fold_draws(k, B) for k in keys]
    tx = [t(np.stack([xes[f][m] for f in range(FOLDS)]))
          for m in range(len(DIMS))]
    tc = [t(np.stack(cs))] * len(DIMS)
    tmask = None if mask is None else t(mask)
    fwd = model(tx, tc, t(np.stack([d[0] for d in draws])), train=train,
                mask=tmask,
                keep=[t(np.stack([d[1][i] for d in draws]))
                      for i in range(len(LAYERS))])
    terms = model.loss(tx, fwd, t(np.stack(labels)), margin=MARGIN,
                       weight_contrastive=WEIGHT_CON, mask=tmask)
    assert set(terms) == set(model.log_keys)
    terms["total_loss"].sum().backward()
    got_grads = {k: p.grad for k, p in model.named_parameters()}
    for f in range(FOLDS):
        m = None if mask is None else mask[f]

        def objective(p, f=f, m=m):
            out = jmodel.forward(p, xes[f], [cs[f]] * len(DIMS), keys[f],
                                 train=train, mask=m)
            lo = jmodel.loss(p, xes[f], out, labels[f], margin=MARGIN,
                             weight_contrastive=WEIGHT_CON, mask=m)
            return lo["total_loss"], (out, lo)

        (_, (ref, ref_terms)), ref_grads = jax.value_and_grad(
            objective, has_aux=True)(trees[f])
        for k in model.log_keys:
            close(terms[k][f].detach(), ref_terms[k], err_msg=k, **TOL)
        close(fwd["logits"][f].detach(), ref["logits"], **TOL)
        close(fwd["mu"][f].detach(), ref["mu"], **TOL)
        for bank in ("recons_health", "recons_disease"):
            for (mean, lv), (rmean, rlv) in zip(fwd[bank], ref[bank]):
                close(mean[f].detach(), rmean, **TOL)
                close(lv[f].detach(), rlv, **TOL)
        for (mean, var), s in zip(fwd["bn_state"], ref["bn_state"]):
            close(mean[f], s["mean"], **TOL)
            close(var[f], s["var"], **TOL)
        # every gradient, through the interop naming
        ref_flat = {jax.tree_util.keystr(p): v for p, v in
                    jax.tree_util.tree_leaves_with_path(ref_grads)}
        got_tree = params_to_jax(_grad_model(model, got_grads), fold=f)
        got_flat = {jax.tree_util.keystr(p): v for p, v in
                    jax.tree_util.tree_leaves_with_path(got_tree)}
        for path, want in ref_flat.items():
            if "bn_state" in path:
                # the port keeps the running statistics as buffers: no
                # gradient, and in train mode JAX's is zero too
                if train:
                    assert not np.any(np.asarray(want))
                continue
            if "'blocks'" in path and path.endswith("['linear']['b']"):
                check_bias_grad(got_flat[path], want,
                                got_flat[path[:-len("['b']")] + "['w']"], train)
                continue
            close(got_flat[path], want, err_msg=path, **GRAD_TOL)


def _grad_model(model, grads):
    """A copy of ``model`` whose parameters hold their gradients (buffers
    zero), to read the gradients back as a JAX-layout tree."""
    copy = EndToEndCVAE(model.input_dim_list, model.hidden_dim,
                        model.latent_dim, model.c_dim, model.modalities,
                        classifier_layers=model.classifier_layers,
                        folds=model.folds)
    with torch.no_grad():
        for name, p in copy.named_parameters():
            p.copy_(grads[name])
        for b in copy.buffers():
            b.zero_()
    return copy


def test_predict_matches_jax_and_the_plain_path():
    """Eval-mode logits from the fused mean: ``predict`` (the encoder
    kernel's wrapper, its plain version on CPU tensors) and
    ``predict_reference`` against JAX predict per fold."""
    jmodel, trees, model = make_pair(seed=4)
    xes, cs, _ = make_inputs(5, rows=33)
    tx = [t(np.stack([xes[f][m] for f in range(FOLDS)]))
          for m in range(len(DIMS))]
    tc = [t(np.stack(cs))] * len(DIMS)
    logits = model.predict(tx, tc)
    assert torch.equal(logits, model.predict_reference(tx, tc))
    for f in range(FOLDS):
        close(logits[f], jmodel.predict(trees[f], xes[f],
                                        [cs[f]] * len(DIMS)), **TOL)


def test_interop_round_trip_and_checkpoint_bytes():
    _, trees, model = make_pair(seed=6)
    for f in range(FOLDS):
        got = params_to_jax(model, fold=f)
        assert (jax.tree_util.tree_structure(got)
                == jax.tree_util.tree_structure(trees[f]))
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(trees[f])):
            assert np.array_equal(a, b)
        # the port's checkpoint writer gives flax's bytes
        assert to_bytes(got) == serialization.to_bytes(trees[f])
    assert {k for k, _ in model.named_buffers()} == {
        f"classifier.state.{i}.{s}" for i in range(len(LAYERS))
        for s in ("mean", "var")}


# ---- training ------------------------------------------------------------------

SIZES = (37, 21)
EPOCHS, BATCH = 4, 16


def _cohort(rng, n):
    data = [rng.standard_normal((n, d)).astype(np.float32) for d in DIMS]
    cov = rng.standard_normal((n, C)).astype(np.float32)
    labels = rng.integers(0, 2, n).astype(np.float32)[:, None]
    return data, [cov] * len(DIMS), {"labels": labels}


# the leaves of a classifier block's linear bias and running mean: in train
# mode BatchNorm takes the batch mean right after the linear, so the bias's
# gradient is zero and each side computes rounding of a zero (about 1e-7),
# which Adam scales up to a step of about lr in a direction the rounding
# picks; the running mean carries the bias. In fp32 those leaves wander
# apart by up to steps x lr; in fp64 the rounding is 1e-16, far under
# Adam's eps, and every leaf is held at the bound.
def _sign_noise_leaf(path: str) -> bool:
    return (("'blocks'" in path and path.endswith("['linear']['b']"))
            or (path.startswith("['bn_state']") and path.endswith("['mean']")))


@pytest.mark.parametrize("precision", ["fp32", "fp64"])
def test_ragged_two_fold_trajectory_matches_jax(precision):
    """The nm-PM-cont CLI's loss and BatchNorm state update in the port's
    MultiFoldTrainer against JAX's (cli/nmpmcont.py:154-168), both folds
    from the CLI's one init and key 42, on replayed noise and keep masks:
    every logged term, the parameters and the running statistics (in fp32
    all but the sign-noise leaves above)."""
    fp64 = precision == "fp64"
    jmodel, trees, model = make_pair(folds=2, seed=7)
    tree = trees[0]
    if fp64:
        tree = jax.tree_util.tree_map(lambda a: a.astype(np.float64), tree)
    params_from_jax(stack_params([tree, tree]), model)
    if fp64:
        model.double()
    rng = np.random.default_rng(7)
    cohorts = [_cohort(rng, n) for n in SIZES]
    data = [c[0] for c in cohorts]
    cov = [c[1] for c in cohorts]
    extras = [c[2] for c in cohorts]

    def jax_loss(p, batch, k):
        labels = batch["extras"]["labels"][:, 0].astype(np.int32)
        fwd = jmodel.forward(p, list(batch["x"]), list(batch["c"]), k,
                             train=True, mask=batch["mask"])
        lo = jmodel.loss(p, list(batch["x"]), fwd, labels, margin=MARGIN,
                         weight_contrastive=WEIGHT_CON, mask=batch["mask"])
        lo["__bn_state__"] = fwd["bn_state"]
        return lo["total_loss"], lo

    def jax_state_update(p, aux):
        return {**p, "bn_state": aux["__bn_state__"]}

    config = TrainConfig(epochs=EPOCHS, batch_size=BATCH, combine="poe")
    batches = stack_fold_batches(data, cov, BATCH, extras=extras)
    assert batches["valid"].tolist() == [[True] * 3, [True, True, False]]
    assert batches["extras"]["labels"].shape == (2, 3, BATCH, 1)
    jconfig = JaxConfig(epochs=EPOCHS, batch_size=BATCH, learning_rate=1e-4,
                        combine="poe", seed=42)
    key = jax.random.PRNGKey(42)
    with jax.enable_x64(fp64):
        ref_params, ref_logs = JaxMultiFoldTrainer(
            jmodel, jconfig, max(SIZES), loss_fn=jax_loss,
            state_update=jax_state_update).run(
                jax_stack_params([tree, tree]),
                jax.device_put(jax_stack_fold_batches(data, cov, BATCH,
                                                      extras=extras)),
                jnp.stack([key, key]))
        ref = numpy_tree(ref_params)
        ref_logs = numpy_tree(ref_logs)
        draws = jax_draws(batches["valid"], EPOCHS, BATCH, Z, LAYERS,
                          dtype=np.float64 if fp64 else np.float32)
    logs = MultiFoldTrainer(
        model, config, max(SIZES),
        loss_fn=endtoend_loss_fn(model, MARGIN, WEIGHT_CON),
        state_update=model.update_state).run(batches, **draws)

    assert set(logs) == set(model.log_keys)
    for k in model.log_keys:
        assert logs[k].shape == (2, EPOCHS) and np.isfinite(logs[k]).all()
        close(logs[k], ref_logs[k], rtol=1e-4, err_msg=k)
    got = params_to_jax(model)
    for path, want in jax.tree_util.tree_leaves_with_path(ref):
        name = jax.tree_util.keystr(path)
        leaf = got
        for p in path:
            leaf = leaf[p.key if hasattr(p, "key") else p.idx]
        assert np.isfinite(leaf).all(), name
        if fp64 or not _sign_noise_leaf(name):
            close(leaf, want, rtol=5e-3, atol=1e-5, err_msg=name)
    # the running statistics moved, and (above) by the same steps in both
    for f in range(2):
        assert not np.array_equal(got["bn_state"][0]["var"][f],
                                  tree["bn_state"][0]["var"])


def test_production_draws_are_per_fold_and_seeded():
    """Without replayed draws every fold draws its own noise and keep
    masks from a generator seeded 42: two runs train alike, and two folds
    that start alike on the same data stay alike."""
    rng = np.random.default_rng(8)
    cohort = _cohort(rng, 20)

    def train():
        _, trees, model = make_pair(folds=2, seed=8)
        params_from_jax(stack_params([trees[0], trees[0]]), model)
        config = TrainConfig(epochs=2, batch_size=8, combine="poe")
        MultiFoldTrainer(model, config, 20,
                         loss_fn=endtoend_loss_fn(model, MARGIN, WEIGHT_CON),
                         state_update=model.update_state).run(
            stack_fold_batches([cohort[0]] * 2, [cohort[1]] * 2, 8,
                               extras=[cohort[2]] * 2))
        return model.state_dict()

    a, b = train(), train()
    for k, v in a.items():
        assert torch.equal(v, b[k]), k
        assert torch.equal(v[0], v[1]), k
