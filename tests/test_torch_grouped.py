"""The width-grouped layout (models/grouped.py, train/grouped.py) against the
JAX package, on the CPU.

Widths [16, 24, 16, 8] make three groups whose grouped order [0, 2, 1, 3]
is not the cohort's, so every path that must return to the cohort's order
(gPoE's alpha, mmJSD's ordered-pair JSD, the unpacked checkpoints) is
exercised. The packed tree of every fold is JAX ``pack_params``' leaf for
leaf; forward and loss are held at rtol 1e-5 and gradients at rtol 2e-4
(tests/test_grouped.py's bounds) on the noise JAX draws from the same key,
and the trajectories of ``GroupedMultiFoldTrainer`` (every fold at once)
to JAX's sequential ``GroupedFoldTrainer`` at logs rtol 2e-4 and params
rtol 5e-3 / atol 5e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_normative_modeling_tpu.models.grouped import (
    GroupedStackedCVAE as JaxGrouped,
    width_groups as jax_width_groups,
)
from multi_modal_normative_modeling_tpu.train import TrainConfig as JaxConfig
from multi_modal_normative_modeling_tpu.train import grouped as jax_grouped
from multi_modal_normative_modeling_tpu_torch.interop import (
    packed_from_jax,
    packed_to_jax,
)
from multi_modal_normative_modeling_tpu_torch.models.grouped import (
    GroupedStackedCVAE,
    width_groups,
)
from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
from multi_modal_normative_modeling_tpu_torch.train import grouped
from tests.test_torch_endtoend import jax_draws
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
Z, B, FOLDS = 5, 9, 2
TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("dims", [[90, 90, 90, 270], [16, 12], [7, 7],
                                  [270, 90, 270, 90], DIMS])
def test_width_groups_match_jax(dims):
    assert width_groups(dims) == jax_width_groups(dims)
    layout = GroupedStackedCVAE(dims, HIDDEN, Z, C, len(dims))
    jlayout = JaxGrouped(dims, HIDDEN, Z, C, len(dims))
    assert layout.perm == jlayout.perm
    assert list(layout.inv_perm) == list(jlayout.inv_perm)


def _trees(variant="cvae", extra=None, dims=DIMS):
    """Two folds' JAX init trees (different seeds)."""
    from multi_modal_normative_modeling_tpu.models.multimodal import (
        MultimodalCVAE as JaxMultimodalCVAE,
    )

    jmodel = JaxMultimodalCVAE(dims, HIDDEN, Z, C, len(dims),
                               variant=variant, **(extra or {}))
    return [numpy_tree(jmodel.init_params(jax.random.PRNGKey(s)))
            for s in range(FOLDS)]


def test_pack_params_match_jax_and_round_trip():
    trees = _trees()
    layout = GroupedStackedCVAE(DIMS, HIDDEN, Z, C, len(DIMS))
    jlayout = JaxGrouped(DIMS, HIDDEN, Z, C, len(DIMS))
    packed = packed_from_jax(trees, layout)
    for f, tree in enumerate(trees):
        ref = numpy_tree(jlayout.pack_params(tree))
        got = jax.tree_util.tree_map(lambda t, f=f: t[f].numpy(), packed)
        ref_leaves, ref_def = jax.tree_util.tree_flatten(ref)
        got_leaves, got_def = jax.tree_util.tree_flatten(got)
        assert got_def == ref_def
        for a, b in zip(got_leaves, ref_leaves):
            np.testing.assert_array_equal(a, b)
        back = packed_to_jax(packed, layout, fold=f)
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(a, b)


# name -> (variant, combine, extra)
CASES = {
    "cvae-poe": ("cvae", "poe", {}),
    "cvae-gpoe": ("cvae", "gpoe", {}),
    "cvae-moe": ("cvae", "moe", {}),
    "cvae-mopoe": ("cvae", "mopoe", {}),
    "mmjsd": ("mmjsd", "gpoe", {}),
    "mmjsd-per-modality-jsd": ("mmjsd", "poe", {"jsd_on_fused": False}),
    "mvtcae-gpoe": ("mvtcae", "gpoe", {}),
    "mvtcae-poe": ("mvtcae", "poe", {}),
    "nmmlp": ("nmmlp", "moe", {}),
}
# the mvtcae poe quirk amplifies fp32 rounding (tests/test_torch_stacked.py):
# held in fp64
FP64_CASES = {"mvtcae-poe"}


def _inputs(dtype):
    rng = np.random.default_rng(1)
    xes = [rng.standard_normal((FOLDS, B, d)).astype(dtype) for d in DIMS]
    c = rng.standard_normal((FOLDS, B, C)).astype(dtype)
    mask = np.ones((FOLDS, B), dtype)
    mask[0, B - 3:] = 0.0
    return xes, c, mask


@pytest.mark.parametrize("case", CASES)
def test_forward_loss_and_grads_match_jax(case):
    fp64 = case in FP64_CASES
    with jax.enable_x64(fp64):
        _check(case, fp64)


def _check(case, fp64):
    variant, combine, extra = CASES[case]
    dtype = np.float64 if fp64 else np.float32
    tdtype = torch.float64 if fp64 else torch.float32
    trees = [jax.tree_util.tree_map(lambda a: a.astype(dtype), t)
             for t in _trees(variant, extra)]
    layout = GroupedStackedCVAE(DIMS, HIDDEN, Z, C, len(DIMS),
                                variant=variant, **extra)
    jlayout = JaxGrouped(DIMS, HIDDEN, Z, C, len(DIMS), variant=variant,
                         **extra)
    xes, c, mask = _inputs(dtype)
    keys = [jax.random.PRNGKey(7 + f) for f in range(FOLDS)]
    eps = np.stack([np.asarray(jax.random.normal(k, (B, Z), dtype))
                    for k in keys])

    packed = packed_from_jax(trees, layout)
    leaves, treedef = jax.tree_util.tree_flatten(packed)
    leaves = [t.to(tdtype).requires_grad_() for t in leaves]
    packed = jax.tree_util.tree_unflatten(treedef, leaves)
    x_groups = tuple(g.to(tdtype) for g in layout.pack_inputs(xes))
    fwd = layout.forward(packed, x_groups, torch.from_numpy(c), combine,
                         torch.from_numpy(eps))
    loss = layout.loss(packed, x_groups, fwd, torch.from_numpy(mask))
    grads = torch.autograd.grad(loss["total"].sum(), leaves,
                                allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]

    def run(p, jx, jc, jmask, key):
        out = jlayout.forward(p, jx, jc, key, combine)
        return jlayout.loss(p, jx, out, jmask), out

    run_jit = jax.jit(run)
    grad_jit = jax.jit(jax.grad(lambda *a: run(*a)[0]["total"]))
    for f, tree in enumerate(trees):
        jpacked = jlayout.pack_params(tree)
        args = (tuple(jnp.asarray(g) for g in
                      jlayout.pack_inputs([x[f] for x in xes])),
                jnp.asarray(c[f]), jnp.asarray(mask[f]), keys[f])
        ref_loss, ref_fwd = run_jit(jpacked, *args)
        assert set(loss) == set(ref_loss)
        for k in ref_loss:
            close(loss[k][f].item(), float(ref_loss[k]), err_msg=k, **TOL)
        for gi in range(len(layout.groups)):
            close(fwd["recon_means"][gi][f].detach(),
                  ref_fwd["recon_means"][gi], rtol=1e-4, atol=1e-5)
        close(fwd["mus"][f].detach(), ref_fwd["mus"], rtol=1e-4, atol=1e-5)
        ref_grads = grad_jit(jpacked, *args)
        for a, b in zip(grads, jax.tree_util.tree_leaves(ref_grads)):
            close(a[f], b, **GRAD_TOL)
    for a, b in zip(layout.pred_recon(packed, x_groups, torch.from_numpy(c),
                                      combine, torch.from_numpy(eps)),
                    fwd["recon_means"]):
        assert torch.equal(a, b)
    # the deviations, per modality in grouped order
    dev = layout.reconstruction_deviation(x_groups, fwd["recon_means"])
    assert dev.shape == (FOLDS, len(DIMS), B)
    ref_dev = jlayout.reconstruction_deviation(
        tuple(jnp.asarray(g) for g in
              jlayout.pack_inputs([x[0] for x in xes])),
        tuple(np.asarray(r[0].detach()) for r in fwd["recon_means"]))
    close(dev[0].detach(), ref_dev, rtol=1e-5, atol=1e-7)


def test_per_modality_jsd_unpermutes_the_grouped_stats():
    """mmJSD's per-modality JSD runs over ordered pairs: the grouped layout
    equals the padded one (the cohort's order), which a permuted order
    would not."""
    from multi_modal_normative_modeling_tpu_torch.models.stacked import (
        StackedMultimodalCVAE,
    )

    extra = {"jsd_on_fused": False}
    trees = _trees("mmjsd", extra)
    layout = GroupedStackedCVAE(DIMS, HIDDEN, Z, C, len(DIMS),
                                variant="mmjsd", **extra)
    padded = StackedMultimodalCVAE(DIMS, HIDDEN, Z, C, len(DIMS),
                                   variant="mmjsd", **extra)
    assert layout.perm != list(range(len(DIMS)))
    xes, c, mask = _inputs(np.float32)
    eps = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (FOLDS, B, Z)).astype(np.float32))
    tc, tm = torch.from_numpy(c), torch.from_numpy(mask)
    pg = packed_from_jax(trees, layout)
    xg = layout.pack_inputs(xes)
    jsd = layout.loss(pg, xg, layout.forward(pg, xg, tc, "poe", eps),
                      tm)["jsd"]
    pp = packed_from_jax(trees, padded)
    xp = padded.pack_inputs(xes)
    ref = padded.loss(pp, xp, padded.forward(pp, xp, tc, "poe", eps),
                      tm)["jsd"]
    assert torch.all(ref != 0)
    close(jsd, ref, rtol=1e-5)


# name -> (model, latent dim, combine, extra)
TRAJECTORIES = {
    "cvae-gpoe": ("cVAE_multimodal", 5, "gpoe", {}),
    "mmjsd-per-modality-jsd": ("mmjsd", 5, "poe", {"jsd_on_fused": False}),
    "mvtcae-poe": ("mvtCAE", 5, "poe", {}),
    "nmmlp-mopoe": ("nmmlp", 5, "mopoe", {}),
}


@pytest.mark.parametrize("case", TRAJECTORIES)
def test_grouped_trajectory_matches_jax_sequential(case):
    name, z, combine, extra = TRAJECTORIES[case]
    jmodel, tree, model = make_jax_port(name, DIMS, z, extra=extra)
    data = cohorts(DIMS, seed=4)
    jconfig = JaxConfig(epochs=EPOCHS, batch_size=BATCH, combine=combine)
    ref = jax_sequential(jax_grouped.GroupedFoldTrainer(jmodel, jconfig, 37),
                         tree, data)
    cls, layout, tag = grouped.select_packed_trainer(model)
    assert (layout, tag) == ("width-grouped", "grouped")
    batches = port_batches(data)
    trainer = cls(model, TrainConfig(epochs=EPOCHS, batch_size=BATCH,
                                     combine=combine), 37)
    logs = trainer.run(batches, **jax_draws(batches["valid"], EPOCHS, BATCH,
                                            model.noise_dim))
    check_trajectory(model, logs, ref)
    assert trainer.loss_meta["loss"] == (
        "packed_grouped" if name == "cVAE_multimodal"
        else f"packed_grouped_{model.variant}")


def test_milestones_are_the_runs_of_their_epoch_counts():
    """run_milestones on the grouped layout: each snapshot is the run of
    that many epochs, bit for bit."""
    data = cohorts(DIMS, seed=5)
    batches = port_batches(data)
    config = TrainConfig(epochs=3, batch_size=BATCH, combine="gpoe")
    model = make_jax_port("cVAE_multimodal", DIMS, 5)[2]
    snaps = list(grouped.GroupedMultiFoldTrainer(model, config, 37)
                 .run_milestones(batches, [1, 3]))
    for epochs, per_fold, logs in snaps:
        alone = make_jax_port("cVAE_multimodal", DIMS, 5)[2]
        cfg = TrainConfig(epochs=epochs, batch_size=BATCH, combine="gpoe")
        ref_logs = grouped.GroupedMultiFoldTrainer(alone, cfg, 37).run(
            batches)
        for k in ref_logs:
            np.testing.assert_array_equal(logs[k], ref_logs[k])
        from multi_modal_normative_modeling_tpu_torch.interop import (
            params_to_jax,
        )

        for f in range(2):
            for a, b in zip(jax.tree_util.tree_leaves(per_fold[f]),
                            jax.tree_util.tree_leaves(
                                params_to_jax(alone, fold=f))):
                np.testing.assert_array_equal(a, b)
