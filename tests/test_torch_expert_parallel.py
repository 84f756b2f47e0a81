"""Expert parallelism (parallel/modality.py) on the CPU, against the JAX
package and the port's unmeshed runs.

In-process: ``ep_divisible_spec`` and the EP meshes' messages against the
JAX functions. Then spawned gloo worlds of two and four ranks (127.0.0.1):
``fused_stats_collective`` for the four fusions against JAX's under
``shard_map`` (tests/test_modality_parallel.py:53's case); one EP step's
loss and every gradient leaf against JAX (``build_ep_step``'s loss, and
``jax.grad`` of the unsharded packed loss on the same draws) at modality
axis 2 and 4 and at ('modality', 'data') 2,2, where each data shard draws
from fold_in(key, d); ``EPFoldTrainer`` over a few epochs against JAX's
``EPFoldTrainer`` at the JAX trajectory bounds (tests/test_packed_cli.py's:
logs rtol 2e-4, parameters rtol 5e-3 / atol 5e-5) and resumed bit for bit;
the ``F,M,D`` form of the padded, width-grouped and end-to-end packed
trainers against their unmeshed runs at rtol 2e-4 / atol 2e-5."""
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from multi_modal_normative_modeling_tpu_torch.interop import params_to_jax
from multi_modal_normative_modeling_tpu_torch.models import build_model
from multi_modal_normative_modeling_tpu_torch.models.endtoend import (
    EndToEndCVAE,
)
from multi_modal_normative_modeling_tpu_torch.models.stacked import (
    StackedMultimodalCVAE,
)
from multi_modal_normative_modeling_tpu_torch.ops.shard import (
    modality_shard,
    part,
)
from multi_modal_normative_modeling_tpu_torch.parallel import (
    stack_fold_batches,
)
from multi_modal_normative_modeling_tpu_torch.parallel.mesh import Mesh
from multi_modal_normative_modeling_tpu_torch.parallel.modality import (
    EPFoldTrainer,
    ModalityShard,
    build_ep_step,
    ep_divisible_spec,
    fused_stats_collective,
    grouped_e2e_fold_shardings,
    grouped_fold_shardings,
    leaf_specs,
    make_ep_mesh,
    make_ep_mesh3,
    packed_fold_shardings,
)
from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
from multi_modal_normative_modeling_tpu_torch.train.grouped import (
    GroupedMultiFoldTrainer,
)
from multi_modal_normative_modeling_tpu_torch.train.packed import (
    PackedMultiFoldTrainer,
)
from multi_modal_normative_modeling_tpu_torch.train.packed_endtoend import (
    GroupedEndToEndTrainer,
)
from tests.test_torch_mesh_cli import join_world, rendezvous
from tests.test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-5)
LOG_TOL = dict(rtol=2e-4)
PARAM_TOL = dict(rtol=5e-3, atol=5e-5)
COMBINES = ("poe", "gpoe", "moe", "mopoe")
# the step problem: tests/test_modality_parallel.py's
STEP_DIMS, STEP_C, STEP_Z, STEP_B = [12, 16, 9, 16], 5, 7, 8
STATS_M, STATS_B, STATS_Z = 4, 6, 5
# the trainer problems
HIDDEN, Z, C, BATCH, EPOCHS = [10, 8], 4, 3, 8, 3
SIZES = (29, 21)


# ---- plans and messages (in-process) ----------------------------------------

@pytest.mark.parametrize("shape,nm", [((2, 4, 3), 2), ((2, 3, 3), 2),
                                      ((2, 4), 4), ((2,), 2), ((2, 6, 5), 3)])
def test_ep_divisible_spec_matches_jax(shape, nm):
    from multi_modal_normative_modeling_tpu.parallel import modality as jmod

    assert ep_divisible_spec(nm, shape) == tuple(
        jmod.ep_divisible_spec(nm, shape))


def test_plans_split_what_divides():
    """Uniform [M] leaves split; a ragged group of 3 modalities stays whole
    on a 2-way axis; every rank of a 2,2,1 mesh holds its fold."""
    mesh = Mesh({"fold": 2, "modality": 2, "data": 1}, 3)
    tree = {"layer0": [{"w": torch.zeros(4, 3, 5, 6)},
                       {"w": torch.zeros(4, 2, 5, 6)}],
            "alpha": torch.zeros(4, 4)}
    assert leaf_specs(mesh, tree) == {
        "layer0": [{"w": ("fold",)},
                   {"w": ("fold", "modality", None, None)}],
        "alpha": ("fold", "modality")}
    for fn in (packed_fold_shardings, grouped_fold_shardings,
               grouped_e2e_fold_shardings):
        plan = fn(mesh, 4, 8)
        assert plan.folds == (2, 4) and plan.rows == (0, 8)
    assert not grouped_e2e_fold_shardings(mesh, 4, 8).shard_x


def _message(fn, *args, **kwargs):
    with pytest.raises(ValueError) as info:
        fn(*args, **kwargs)
    return str(info.value)


def test_ep_mesh_messages_match_jax(monkeypatch):
    import jax

    from multi_modal_normative_modeling_tpu.parallel import modality as jmod

    monkeypatch.setenv("WORLD_SIZE", "8")
    devices = jax.devices()[:8]
    for args in ((3,), (3, 2), (2, 3)):
        assert _message(make_ep_mesh, *args) == _message(
            jmod.make_ep_mesh, *args, devices=devices)
    for args in ((3, 2), (2, 2, 3), (1, 3, None)):
        assert _message(make_ep_mesh3, *args) == _message(
            jmod.make_ep_mesh3, *args, devices=devices)


# ---- inputs ----------------------------------------------------------------

def _stats_inputs():
    rng = np.random.default_rng(1)
    mus = rng.normal(size=(STATS_M, STATS_B, STATS_Z)).astype(np.float32)
    variances = rng.uniform(0.2, 2.0, size=(STATS_M, STATS_B, STATS_Z)
                            ).astype(np.float32)
    alpha = rng.normal(size=(STATS_M,)).astype(np.float32)
    return mus, variances, alpha


def _step_inputs():
    """(JAX init tree of the packed layout, x_packed, c, mask): the JAX
    test's problem with the last two rows masked out."""
    rng = np.random.default_rng(0)
    xes = [rng.normal(size=(STEP_B, d)).astype(np.float32)
           for d in STEP_DIMS]
    c = rng.normal(size=(STEP_B, STEP_C)).astype(np.float32)
    mask = np.ones(STEP_B, np.float32)
    mask[-2:] = 0.0
    return xes, c, mask


def _step_tree():
    import jax

    from multi_modal_normative_modeling_tpu.models.stacked import (
        StackedMultimodalCVAE as JaxStacked,
    )

    stacked = JaxStacked(STEP_DIMS, [14, 10], STEP_Z, STEP_C, len(STEP_DIMS))
    return stacked, jax.tree_util.tree_map(
        np.asarray, stacked.init_params(jax.random.PRNGKey(0)))


def _fold_arrays(dims, sizes=SIZES, seed=0):
    """Per fold: (per-modality data, the covariate block, labels)."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        data = [rng.standard_normal((n, d)).astype(np.float32)
                for d in dims]
        c = rng.standard_normal((n, C)).astype(np.float32)
        out.append((data, c, rng.integers(0, 2, n).astype(
            np.float32)[:, None]))
    return out


def _cohorts(dims, sizes=SIZES, seed=0, labels=False):
    folds = _fold_arrays(dims, sizes, seed)
    return stack_fold_batches(
        [d for d, _, _ in folds], [[c] * len(dims) for _, c, _ in folds],
        BATCH, extras=[{"labels": y} for _, _, y in folds]
        if labels else None)


# ---- rank jobs -----------------------------------------------------------------

def _stats_job(mesh):
    """Each fusion's fused statistics from this rank's modalities."""
    mus, variances, alpha = (torch.from_numpy(a)[None]
                             for a in _stats_inputs())
    shard = ModalityShard(mesh)
    with modality_shard(shard):
        mine = [part(t, STATS_M) for t in (mus, variances)]
    return {combine: [t[0].numpy() for t in fused_stats_collective(
        mine[0], mine[1], combine, alpha, STATS_M, mesh)]
        for combine in COMBINES}


def _step_job(mesh, eps_full, tree):
    """One EP step's loss and whole gradients, gathered on every rank."""
    xes, c, mask = _step_inputs()
    stacked = StackedMultimodalCVAE(STEP_DIMS, [14, 10], STEP_Z, STEP_C,
                                    len(STEP_DIMS))
    x = stacked.pack_inputs(xes)[None]
    shard = ModalityShard(mesh)
    nd, d = mesh.axis("data"), mesh.index("data")
    rows = slice(d * STEP_B // nd, (d + 1) * STEP_B // nd)
    out = {}
    for combine in COMBINES:
        from multi_modal_normative_modeling_tpu_torch.train.packed import (
            _leaves,
            _rebuild,
        )

        with modality_shard(shard):
            local = _rebuild(tree, [
                part(torch.from_numpy(np.asarray(a))[None], a.shape[0])
                .clone().requires_grad_(True) for a in _leaves(tree)])
            x_local = part(x, len(STEP_DIMS))[:, :, rows].contiguous()
        step = build_ep_step(stacked, combine, mesh)
        loss, grads = step(local, x_local,
                           torch.from_numpy(c)[None, rows],
                           torch.from_numpy(eps_full)[None, rows],
                           torch.from_numpy(mask)[None, rows])
        pieces = mesh.all_gather_object(
            (mesh.index("modality"), d,
             [g[0].detach().numpy() for g in _leaves(grads)]))
        nm = mesh.axis("modality")
        by = {m: g for m, dd, g in pieces if dd == 0}
        whole = [np.concatenate([by[m][i] for m in range(nm)], axis=0)
                 for i in range(len(by[0]))]
        out[combine] = (float(loss[0]), whole)
    return out


def _model(dims, name="cVAE_multimodal", folds=2, cls=None):
    gen = torch.Generator().manual_seed(0)
    if cls is not None:
        return cls(dims, HIDDEN, Z, C, len(dims), folds=folds,
                   generator=gen)
    return build_model(name, dims, HIDDEN, Z, C, len(dims), folds=folds,
                       generator=gen)


def _packed_run(trainer_cls, dims, mesh=None, shardings=None,
                name="cVAE_multimodal", combine="gpoe", labels=False,
                **extra):
    """A packed trainer's trained model and logs; production draws."""
    cls = EndToEndCVAE if trainer_cls is GroupedEndToEndTrainer else None
    model = _model(dims, name, cls=cls)
    config = TrainConfig(epochs=EPOCHS, batch_size=BATCH, combine=combine)
    kwargs = dict(extra)
    if mesh is not None:
        kwargs.update(mesh=mesh, shardings_fn=shardings)
    trainer = trainer_cls(model, config, max(SIZES), **kwargs)
    logs = trainer.run(_cohorts(dims, labels=labels))
    return ({n: p.detach().numpy().copy()
             for n, p in model.named_parameters()}, logs)


def _e2e(mesh=None, shardings=None):
    return _packed_run(GroupedEndToEndTrainer, [12, 20], mesh, shardings,
                       labels=True, margin=1.0, weight_contrastive=0.1)


def _ep_trainer(mesh, dims, combine, draws=None, state=None, epochs=EPOCHS,
                every=0, resume=False, init=None):
    model = _model(dims)
    if init is not None:
        from multi_modal_normative_modeling_tpu_torch.interop import (
            params_from_jax,
        )
        from multi_modal_normative_modeling_tpu_torch.parallel import (
            stack_params,
        )

        params_from_jax(stack_params([init] * 2), model)
    config = TrainConfig(epochs=epochs, batch_size=BATCH, combine=combine)
    trainer = EPFoldTrainer(model, config, max(SIZES), mesh)
    batches = _cohorts(dims)
    if every:
        logs = trainer.run_resumable(batches, state, every, resume)
    else:
        logs = trainer.run(batches, **(draws or {}))
    return ({n: p.detach().numpy().copy()
             for n, p in model.named_parameters()}, logs,
            [params_to_jax(model, fold=f) for f in range(2)])


FMD_GROUPED = {"grouped ragged": [12, 12, 12, 20],
               "grouped split": [12, 20, 12, 20]}


def _two_ranks(rank, world, store, out, inputs):
    join_world(rank, world, store)
    inputs = pickle.loads(Path(inputs).read_bytes())
    res = {}
    m2 = make_ep_mesh(2, 1)
    res["stats"] = _stats_job(m2)
    res["step 2,1"] = _step_job(m2, inputs["eps 1"], inputs["tree"])
    res["trainer"] = {combine: _ep_trainer(
        m2, [12, 12], combine, draws=inputs["draws"],
        init=inputs["init"])[2] for combine in ("gpoe", "poe")}
    state = Path(out).parent / "state"
    res["straight"] = _ep_trainer(m2, [12, 12], "gpoe", epochs=4)[:2]
    _ep_trainer(m2, [12, 12], "gpoe", state=state, epochs=2, every=1)
    res["resumed"] = _ep_trainer(m2, [12, 12], "gpoe", state=state,
                                 epochs=4, every=1, resume=True)[:2]
    fmd = make_ep_mesh3(1, 2, 1)
    res["padded"] = _packed_run(PackedMultiFoldTrainer, [12, 12], fmd,
                                packed_fold_shardings)
    res["padded mmjsd"] = _packed_run(PackedMultiFoldTrainer, [12, 12], fmd,
                                      packed_fold_shardings, name="mmJSD",
                                      combine="poe")
    for key, dims in FMD_GROUPED.items():
        res[key] = _packed_run(GroupedMultiFoldTrainer, dims, fmd,
                               grouped_fold_shardings)
    res["e2e"] = _e2e(fmd, grouped_e2e_fold_shardings)
    if rank == 0:
        Path(out).write_bytes(pickle.dumps(res))


def _four_ranks(rank, world, store, out, inputs):
    join_world(rank, world, store)
    inputs = pickle.loads(Path(inputs).read_bytes())
    res = {"step 4,1": _step_job(make_ep_mesh(4, 1), inputs["eps 1"],
                                 inputs["tree"]),
           "step 2,2": _step_job(make_ep_mesh(2, 2), inputs["eps 2"],
                                 inputs["tree"])}
    res["stats 4"] = _stats_job(make_ep_mesh(4, 1))
    res["padded 2,2,1"] = _packed_run(PackedMultiFoldTrainer, [12, 12],
                                      make_ep_mesh3(2, 2, 1),
                                      packed_fold_shardings)
    res["grouped 1,2,2"] = _packed_run(GroupedMultiFoldTrainer,
                                       FMD_GROUPED["grouped split"],
                                       make_ep_mesh3(1, 2, 2),
                                       grouped_fold_shardings)
    if rank == 0:
        Path(out).write_bytes(pickle.dumps(res))


# ---- the JAX side (main process) ------------------------------------------------

STEP_KEY = 11


def _eps(n_data):
    """The noise JAX's EP step draws, rows of data shard d from
    fold_in(key, d) when the data axis is wider than 1."""
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey(STEP_KEY)
    if n_data == 1:
        return np.asarray(jax.random.normal(key, (STEP_B, STEP_Z),
                                            jnp.float32))
    b = STEP_B // n_data
    return np.concatenate([np.asarray(jax.random.normal(
        jax.random.fold_in(key, d), (b, STEP_Z), jnp.float32))
        for d in range(n_data)])


def _jax_step(combine, eps, n_modality, n_data, monkeypatch):
    """(build_ep_step's loss on the JAX mesh, the unsharded loss's
    gradient leaves on the same draws, flattened like the port's tree)."""
    import jax
    import jax.numpy as jnp
    import optax

    import multi_modal_normative_modeling_tpu.models.stacked as jstacked_mod
    from multi_modal_normative_modeling_tpu.parallel import modality as jmod

    stacked, tree = _step_tree()
    xes, c, mask = _step_inputs()
    x = stacked.pack_inputs(xes)
    mesh = jmod.make_ep_mesh(n_modality, n_data,
                             devices=jax.devices()[:n_modality * n_data])
    opt = optax.adam(1e-3)
    step = jmod.build_ep_step(stacked, opt, combine, mesh)
    _, _, loss = step(tree, opt.init(tree), x, c,
                      jax.random.PRNGKey(STEP_KEY), jnp.asarray(mask))
    monkeypatch.setattr(jstacked_mod, "reparameterize",
                        lambda key, mu, lv: mu + eps * jnp.exp(0.5 * lv))

    def loss_fn(p):
        fwd = stacked.forward(p, x, c, jax.random.PRNGKey(0), combine)
        return stacked.loss(p, x, fwd, jnp.asarray(mask))["total"]

    grads = jax.grad(loss_fn)(tree)
    monkeypatch.undo()
    from multi_modal_normative_modeling_tpu_torch.train.packed import _leaves

    return float(loss), [np.asarray(g) for g in _leaves(
        jax.tree_util.tree_map(np.asarray, grads))]


def _inputs(tmp_path):
    import jax

    from multi_modal_normative_modeling_tpu.models.multimodal import (
        MultimodalCVAE as JaxCVAE,
    )
    from tests.test_torch_endtoend import jax_draws

    _, tree = _step_tree()
    init = jax.tree_util.tree_map(np.asarray, JaxCVAE(
        [12, 12], HIDDEN, Z, C, 2).init_params(jax.random.PRNGKey(0)))
    valid = _cohorts([12, 12])["valid"]
    inputs = {"tree": tree, "eps 1": _eps(1), "eps 2": _eps(2),
              "init": init,
              "draws": jax_draws(valid, EPOCHS, BATCH, Z)}
    path = tmp_path / "inputs.pkl"
    path.write_bytes(pickle.dumps(inputs))
    return path


def _spawn(fn, world, tmp_path):
    out = tmp_path / "out.pkl"
    inputs = _inputs(tmp_path)
    mp.spawn(fn, args=(world, rendezvous(tmp_path), str(out), str(inputs)),
             nprocs=world)
    return pickle.loads(out.read_bytes())


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _spawn(_two_ranks, 2, tmp_path_factory.mktemp("ep_two"))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _spawn(_four_ranks, 4, tmp_path_factory.mktemp("ep_four"))


# ---- checks ---------------------------------------------------------------------

@pytest.mark.parametrize("combine", COMBINES)
@pytest.mark.parametrize("world", ["two", "four"])
def test_fused_stats_collective_matches_jax(combine, world, request):
    import jax
    from jax.sharding import PartitionSpec as P

    from multi_modal_normative_modeling_tpu.parallel import modality as jmod

    res = request.getfixturevalue(world)
    got = res["stats"] if world == "two" else res["stats 4"]
    nm = 2 if world == "two" else 4
    mus, variances, alpha = _stats_inputs()
    mesh = jmod.make_ep_mesh(n_modality=nm, n_data=1,
                             devices=jax.devices()[:nm])
    fn = jax.shard_map(
        lambda mu, var, a: jmod.fused_stats_collective(
            mu, var, combine, jax.lax.all_gather(a, "modality", tiled=True),
            STATS_M),
        mesh=mesh,
        in_specs=(P("modality", None, None), P("modality", None, None),
                  P("modality")),
        out_specs=(P(), P()))
    for a, b in zip(got[combine], fn(mus, variances, alpha)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("combine", COMBINES)
@pytest.mark.parametrize("geometry", ["2,1", "4,1", "2,2"])
def test_ep_step_loss_and_gradients_match_jax(combine, geometry, two, four,
                                              monkeypatch):
    nm, nd = map(int, geometry.split(","))
    res = two if geometry == "2,1" else four
    loss, grads = res[f"step {geometry}"][combine]
    want_loss, want_grads = _jax_step(combine, _eps(nd), nm, nd,
                                      monkeypatch)
    np.testing.assert_allclose(loss, want_loss, rtol=5e-5)
    assert len(grads) == len(want_grads)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-6)


@pytest.mark.parametrize("combine", ["gpoe", "poe"])
def test_ep_trainer_matches_jax_ep_trainer(combine, two):
    """Fold by fold against JAX's EPFoldTrainer on a 2-way modality mesh,
    both from the JAX init and PRNGKey(42)'s draws."""
    import jax

    from multi_modal_normative_modeling_tpu.models.multimodal import (
        MultimodalCVAE as JaxCVAE,
    )
    from multi_modal_normative_modeling_tpu.parallel import modality as jmod
    from multi_modal_normative_modeling_tpu.train import (
        TrainConfig as JaxConfig,
    )

    jmodel = JaxCVAE([12, 12], HIDDEN, Z, C, 2)
    tree = jax.tree_util.tree_map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(0)))
    mesh = jmod.make_ep_mesh(2, 1, devices=jax.devices()[:2])
    trainer = jmod.EPFoldTrainer(
        jmodel, JaxConfig(epochs=EPOCHS, batch_size=BATCH, combine=combine),
        max(SIZES), mesh)
    for f, (data, cov, _) in enumerate(_fold_arrays([12, 12])):
        want, _ = trainer.run(tree, data, cov, jax.random.PRNGKey(42))
        got = two["trainer"][combine][f]
        for g, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(g, np.asarray(w), **PARAM_TOL)


def test_ep_trainer_resumes_bit_for_bit(two):
    params, logs = two["resumed"]
    ref_params, ref_logs = two["straight"]
    for n in ref_params:
        np.testing.assert_array_equal(params[n], ref_params[n])
    for k in ref_logs:
        np.testing.assert_array_equal(logs[k], ref_logs[k])


def _sign_noise(name: str) -> bool:
    """The end-to-end classifier's pre-BatchNorm biases, whose gradient is
    zero up to rounding (tests/test_torch_endtoend.py:419-428)."""
    return ".blocks." in name and name.endswith(".linear.bias")


def _close(got, want, what):
    params, logs = got
    ref_params, ref_logs = want
    for n in ref_params:
        if _sign_noise(n):
            continue
        np.testing.assert_allclose(params[n], ref_params[n],
                                   err_msg=f"{what} {n}", **TOL)
    for k in ref_logs:
        np.testing.assert_allclose(logs[k], ref_logs[k], err_msg=k, **TOL)


FMD = {
    "padded": lambda: _packed_run(PackedMultiFoldTrainer, [12, 12]),
    "padded mmjsd": lambda: _packed_run(PackedMultiFoldTrainer, [12, 12],
                                        name="mmJSD", combine="poe"),
    "grouped ragged": lambda: _packed_run(GroupedMultiFoldTrainer,
                                          FMD_GROUPED["grouped ragged"]),
    "grouped split": lambda: _packed_run(GroupedMultiFoldTrainer,
                                         FMD_GROUPED["grouped split"]),
    "e2e": _e2e,
}


@pytest.mark.parametrize("name", list(FMD))
def test_fmd_trainers_match_unmeshed_on_two_ranks(two, name):
    _close(two[name], FMD[name](), f"1,2,1 {name}")


@pytest.mark.parametrize("name,ref", [("padded 2,2,1", "padded"),
                                      ("grouped 1,2,2", "grouped split")])
def test_fmd_trainers_match_unmeshed_on_four_ranks(four, name, ref):
    _close(four[name], FMD[ref](), name)
