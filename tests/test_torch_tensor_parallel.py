"""Tensor parallelism over a 'model' mesh axis (parallel/tensor.py), on the
CPU.

In-process: the port's plan against the JAX ``tp_param_specs`` on the same
parameter tree (the port's, in the JAX layout), layer by layer, at several
depths and 'model' sizes; and the Megatron functions' gradients in a world
of one. Then spawns of two and four ranks (gloo on 127.0.0.1) train the
cVAE with ``tensor.fold_model_shardings`` from the JAX init on the JAX
noise (``jax_eps_replay``), against the JAX ``MultiFoldTrainer`` on the
same ('fold', 'data', 'model') mesh over ``jax.devices()[:N]`` and against
the port's unmeshed run. Bounds: port against port rtol 2e-4 / atol 2e-5
(the JAX tensor-parallel test's, tests/test_tensor_parallel.py:100-106);
port against JAX the port's trajectory bounds (logs rtol 1e-4, parameters
rtol 5e-3 / atol 1e-5, tests/test_torch_train.py:281-285)."""
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from multi_modal_normative_modeling_tpu_torch.interop import (
    _get,
    _tree_path,
    params_from_jax,
    params_to_jax,
)
from multi_modal_normative_modeling_tpu_torch.models import build_model
from multi_modal_normative_modeling_tpu_torch.parallel import (
    MultiFoldTrainer,
    fold_model_shardings,
    make_mesh3,
    stack_fold_batches,
    stack_params,
    tp_param_specs,
)
from multi_modal_normative_modeling_tpu_torch.parallel.mesh import Mesh
from multi_modal_normative_modeling_tpu_torch.parallel.tensor import (
    copy_to_model,
    mlp_plan,
    reduce_from_model,
    tp_supported,
)
from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
from tests.test_torch_mesh_cli import join_world, rendezvous
from tests.test_torch_threads import one_torch_thread  # noqa: F401

DIMS, Z, C, BS, EPOCHS = [10, 12], 4, 3, 16, 3
PORT_TOL = dict(rtol=2e-4, atol=2e-5)
JAX_TOL = dict(rtol=5e-3, atol=1e-5)


def _kind(spec) -> str:
    """A JAX weight spec's role: P('fold', None, 'model') is a column
    split, P('fold', 'model', None) a row split."""
    spec = tuple(spec)
    if len(spec) == 3 and spec[2] == "model":
        return "col"
    if len(spec) == 3 and spec[1] == "model":
        return "row"
    return None


@pytest.mark.parametrize("hidden,n_model", [
    ([16, 16], 2), ([16, 16, 16], 2), ([16, 16], 4), ([12, 16, 8], 4),
    ([110, 110], 4), ([16], 2), ([], 2), ([24, 18, 24], 3)])
def test_plan_matches_jax_tp_param_specs(hidden, n_model):
    import jax

    from multi_modal_normative_modeling_tpu.parallel.tensor import (
        make_mesh3 as jax_mesh3,
        tp_param_specs as jax_specs,
    )

    model = build_model("cVAE_multimodal", DIMS, hidden, Z, C, len(DIMS),
                        folds=2)
    tree = params_to_jax(model)
    specs = jax_specs(jax_mesh3(2, 1, n_model,
                                devices=jax.devices()[:2 * n_model]), tree)
    split = tp_param_specs(model, n_model)
    for name, dim in split.items():
        path = _tree_path(name)
        spec = tuple(_get(specs, path))
        if path[-1] == "w":
            assert {"col": 1, "row": 2, None: None}[_kind(spec)] == dim, name
        else:
            # a bias is split with its column-parallel layer only
            assert (dim == 1) == ("model" in spec), name


def test_mlp_plan_breaks_the_alternation_where_a_width_does_not_divide():
    assert mlp_plan([(8, 16), (16, 16), (16, 12)], 4) == (
        ("col", "row", "col"), True)
    assert mlp_plan([(8, 10), (10, 16), (16, 16)], 4) == (
        (None, "col", "row"), False)
    assert mlp_plan([(8, 16)], 1) == ((None,), False)
    dmvae = build_model("DMVAE", DIMS, [16, 16], Z, C, len(DIMS))
    assert "cVAE skeleton" in tp_supported(dmvae)


def test_megatron_functions_in_a_world_of_one():
    """With one 'model' rank both functions are the identity, forward and
    backward."""
    mesh = Mesh({"fold": 1, "data": 1, "model": 1}, 0)
    x = torch.randn(3, 4, requires_grad=True)
    y = reduce_from_model(copy_to_model(x, mesh) * 2.0, mesh)
    (g,) = torch.autograd.grad(y.sum(), x)
    np.testing.assert_array_equal(y.detach().numpy(), (x * 2).detach())
    np.testing.assert_array_equal(g.numpy(), np.full((3, 4), 2.0))


# ---- ranks -------------------------------------------------------------------

def _problem(hidden):
    """The JAX init tree of the cVAE and two folds of 37 and 22 rows
    (fold 1 has an all-padding batch)."""
    import jax

    from multi_modal_normative_modeling_tpu.models import (
        build_model as jax_build,
    )

    jmodel = jax_build("cVAE_multimodal", DIMS, hidden, Z, C, len(DIMS))
    tree = jax.tree_util.tree_map(np.asarray,
                                  jmodel.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    data = [[rng.normal(size=(n, d)).astype(np.float32) for d in DIMS]
            for n in (37, 22)]
    cov = [[rng.normal(size=(n, C)).astype(np.float32)] * len(DIMS)
           for n in (37, 22)]
    return jmodel, tree, data, cov


def _port_run(tree, hidden, data, cov, eps, mesh=None):
    model = build_model("cVAE_multimodal", DIMS, hidden, Z, C, len(DIMS),
                        folds=2)
    params_from_jax(stack_params([tree, tree]), model)
    config = TrainConfig(epochs=EPOCHS, batch_size=BS, combine="gpoe")
    trainer = MultiFoldTrainer(model, config, 37, mesh=mesh,
                               shardings_fn=fold_model_shardings)
    logs = trainer.run(stack_fold_batches(data, cov, BS), eps=eps)
    return params_to_jax(model), logs


def _jax_run(jmodel, tree, data, cov, shape):
    import jax
    import jax.numpy as jnp

    from multi_modal_normative_modeling_tpu.parallel import (
        MultiFoldTrainer as JaxTrainer,
        fold_model_shardings as jax_shardings,
        make_mesh3 as jax_mesh3,
        stack_fold_batches as jax_batches,
        stack_params as jax_stack,
    )
    from multi_modal_normative_modeling_tpu.train import (
        TrainConfig as JaxConfig,
    )

    mesh = jax_mesh3(*shape, devices=jax.devices()[:int(np.prod(shape))])
    trainer = JaxTrainer(jmodel, JaxConfig(epochs=EPOCHS, batch_size=BS,
                                           combine="gpoe"), 37, mesh=mesh,
                         shardings_fn=jax_shardings)
    key = jax.random.PRNGKey(42)
    params, logs = trainer.run(jax_stack([tree, tree]),
                               jax_batches(data, cov, BS),
                               jnp.stack([key, key]))
    return (jax.tree_util.tree_map(np.asarray, params),
            {k: np.asarray(v) for k, v in logs.items()})


def _ranks(rank, world, store, out, jobs):
    join_world(rank, world, store)
    res = {}
    for name, (shape, tree, hidden, data, cov, eps) in jobs.items():
        res[name] = _port_run(tree, hidden, data, cov, eps,
                              make_mesh3(*shape))
    if rank == 0:
        Path(out).write_bytes(pickle.dumps(res))


def _spawn(world, tmp_path, jobs):
    out = tmp_path / "out.pkl"
    mp.spawn(_ranks, args=(world, rendezvous(tmp_path), str(out), jobs),
             nprocs=world)
    return pickle.loads(out.read_bytes())


def _close(got, want, **tol):
    if isinstance(want, dict):
        for k in want:
            _close(got[k], want[k], **tol)
    elif isinstance(want, (list, tuple)):
        for g, w in zip(got, want):
            _close(g, w, **tol)
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _check(name, got, jax_ref, port_ref):
    params, logs = got
    _close(params, port_ref[0], **PORT_TOL)
    for k in ("total", "kl", "ll"):
        np.testing.assert_allclose(logs[k], port_ref[1][k], err_msg=name,
                                   **PORT_TOL)
        np.testing.assert_allclose(logs[k], jax_ref[1][k], err_msg=name,
                                   rtol=1e-4)
    _close(params, jax_ref[0], **JAX_TOL)


@pytest.mark.parametrize("world,hidden,shapes", [
    # odd depth: col, row, col, then row-parallel heads; 11 and 9 columns
    # a rank (a plan read from the split weights would not split them)
    (2, [22, 22, 22], [(1, 1, 2)]),
    (4, [18, 18], [(2, 1, 2), (1, 2, 2)]),
])
def test_tensor_parallel_training_matches_jax(tmp_path, world, hidden,
                                              shapes):
    from tests.test_torch_train import jax_eps_replay

    jmodel, tree, data, cov = _problem(hidden)
    batches = stack_fold_batches(data, cov, BS)
    assert not batches["valid"][1, -1]
    eps = jax_eps_replay(batches["valid"], EPOCHS, BS, Z)
    jax_ref = _jax_run(jmodel, tree, data, cov, shapes[0])
    port_ref = _port_run(tree, hidden, data, cov, eps)
    jobs = {str(shape): (shape, tree, hidden, data, cov, eps)
            for shape in shapes}
    res = _spawn(world, tmp_path, jobs)
    for name, got in res.items():
        _check(name, got, jax_ref, port_ref)
