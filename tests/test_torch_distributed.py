"""The port's process-group start-up (parallel/distributed.py) and the
explicit-collective data-parallel step (parallel/shardmap_step.py), on the
CPU.

In-process: a world of one rank makes no process group; the backend rule;
the host-aligned fold axis against the JAX ``global_fold_mesh`` on the 8
virtual devices; the one-shard step equals the unsharded step. A spawn of
two ranks (gloo on 127.0.0.1) then holds the step's parameters replicated,
its noise decorrelated per shard, and the step against the JAX
``build_dp_step_shardmap`` on 2 virtual devices, JAX's ``fold_in`` draws
replayed (rtol 1e-5 / atol 1e-6 after one Adam step; the JAX test of the
one-shard step holds rtol 1e-6 against itself)."""
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from multi_modal_normative_modeling_tpu_torch.interop import (
    params_from_jax,
    params_to_jax,
)
from multi_modal_normative_modeling_tpu_torch.models import build_model
from multi_modal_normative_modeling_tpu_torch.parallel import distributed
from multi_modal_normative_modeling_tpu_torch.parallel.mesh import make_mesh
from multi_modal_normative_modeling_tpu_torch.parallel.shardmap_step import (
    build_dp_step_shardmap,
    shard_seed,
)
from multi_modal_normative_modeling_tpu_torch.parallel.folds import (
    stack_params,
)
from tests.test_torch_mesh_cli import join_world, rendezvous
from tests.test_torch_threads import one_torch_thread  # noqa: F401

DIMS, C, Z, B, HIDDEN, LR = [20, 28], 5, 6, 32, [12, 12], 1e-3


def test_world_of_one_makes_no_group(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize_distributed() is None
    assert not torch.distributed.is_initialized()
    mesh = make_mesh(1, 1)
    assert (mesh.shape, mesh.rank, mesh.backend) == (
        {"fold": 1, "data": 1}, 0, None)
    assert mesh.all_gather_object(3) == [3]
    t = torch.ones(2)
    assert mesh.all_reduce_(t, "data") is t and t.tolist() == [1.0, 1.0]
    with pytest.raises(ValueError, match="mesh 1x2 != 1 devices"):
        make_mesh(1, 2)


def test_backend_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert distributed.choose_backend("cpu") == "gloo"
    # two ranks on one card: NCCL refuses a duplicate GPU
    assert distributed.choose_backend("cuda") == "gloo"
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert distributed.rank_device("cuda") == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert distributed.choose_backend("cuda") == "nccl"
    assert distributed.rank_device("cuda") == torch.device("cuda", 1)


@pytest.mark.parametrize("n_folds", [1, 2, 3, 5, 10])
def test_fold_axis_matches_jax_global_fold_mesh(n_folds):
    import jax

    from multi_modal_normative_modeling_tpu.parallel.distributed import (
        global_fold_mesh,
    )

    want = global_fold_mesh(n_folds).shape["fold"]
    assert distributed.fold_axis_size(n_folds, jax.device_count(),
                                      jax.local_device_count()) == want
    # two hosts of four ranks: a fold's 'data' ranks stay on one host
    assert distributed.fold_axis_size(5, 8, 4) == 4
    assert distributed.fold_axis_size(3, 8, 4) == 2


def _problem():
    """The JAX test's problem (tests/test_shardmap_step.py:16-23): the
    model's init tree and one batch, numpy."""
    import jax

    from multi_modal_normative_modeling_tpu.models import (
        build_model as jax_build,
    )

    rng = np.random.default_rng(0)
    model = jax_build("cVAE_multimodal", DIMS, HIDDEN, Z, C, len(DIMS))
    tree = jax.tree_util.tree_map(np.asarray,
                                  model.init_params(jax.random.PRNGKey(0)))
    xes = [rng.normal(size=(B, d)).astype(np.float32) for d in DIMS]
    cs = [rng.normal(size=(B, C)).astype(np.float32)] * len(DIMS)
    return model, tree, xes, cs


def _port(tree):
    model = build_model("cVAE_multimodal", DIMS, HIDDEN, Z, C, len(DIMS))
    return params_from_jax(stack_params([tree]), model)


def _close(got, want, **tol):
    if isinstance(want, dict):
        for k in want:
            _close(got[k], want[k], **tol)
    elif isinstance(want, (list, tuple)):
        for g, w in zip(got, want):
            _close(g, w, **tol)
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def test_single_shard_matches_unsharded():
    _, tree, xes, cs = _problem()
    model = _port(tree)
    step = build_dp_step_shardmap(model, LR, "poe", make_mesh(1, 1), seed=7)
    eps = torch.randn((1, B, Z),
                      generator=torch.Generator().manual_seed(7))
    loss = step.step([x[None] for x in xes], [c[None] for c in cs])

    ref = _port(tree)
    xs = [torch.from_numpy(x[None]) for x in xes]
    cc = [torch.from_numpy(c[None]) for c in cs]
    ref_loss = ref.loss(xs, ref(xs, cc, "poe", eps=eps))["total"]
    grads = torch.autograd.grad(ref_loss.sum(), list(ref.parameters()),
                                allow_unused=True)
    with torch.no_grad():
        # optax.adam's first step: m/(1-b1) / (sqrt(v/(1-b2)) + eps); an
        # unused parameter (alpha under poe) has a zero gradient
        for p, g in zip(ref.parameters(), grads):
            if g is not None:
                p -= LR * g / (torch.abs(g) + 1e-8)
    np.testing.assert_allclose(loss.numpy(), ref_loss.detach().numpy(),
                               rtol=1e-6)
    _close(params_to_jax(model), params_to_jax(ref), rtol=1e-5, atol=1e-7)


def _ranks(rank, world, store, out, tree, xes, cs, replay):
    join_world(rank, world, store)
    mesh = make_mesh(1, 2)
    res = {}
    # three steps from the ranks' own generators: replicated parameters
    model = _port(tree)
    step = build_dp_step_shardmap(model, LR, "gpoe", mesh, seed=3)
    res["losses"] = [float(step.step([x[None] for x in xes],
                                     [c[None] for c in cs])[0])
                     for _ in range(3)]
    res["params"] = params_to_jax(model)
    # the batch's second half repeats its first: a replicated draw would
    # give each shard the unsharded half-batch loss
    half = B // 2
    dup_x = [np.concatenate([x[:half], x[:half]])[None] for x in xes]
    dup_c = [np.concatenate([c[:half], c[:half]])[None] for c in cs]
    dup = _port(tree)
    res["dup"] = float(build_dp_step_shardmap(dup, LR, "poe", mesh,
                                              seed=11).step(dup_x, dup_c)[0])
    # JAX's fold_in draws replayed
    jmodel = _port(tree)
    jstep = build_dp_step_shardmap(jmodel, LR, "poe", mesh)
    res["replay_loss"] = float(jstep.step(
        [x[None] for x in xes], [c[None] for c in cs],
        eps=torch.from_numpy(replay[rank][None]))[0])
    res["replay_params"] = params_to_jax(jmodel, fold=0)
    out = Path(out)
    out.with_suffix(f".{rank}").write_bytes(pickle.dumps(res))


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    import jax

    jmodel, tree, xes, cs = _problem()
    key = jax.random.PRNGKey(11)
    replay = [np.asarray(jax.random.normal(jax.random.fold_in(key, i),
                                           (B // 2, Z))) for i in range(2)]
    out = tmp_path_factory.mktemp("shardmap") / "out"
    mp.spawn(_ranks, args=(2, rendezvous(out.parent), str(out), tree, xes,
                           cs, replay), nprocs=2)
    ranks = [pickle.loads(out.with_suffix(f".{r}").read_bytes())
             for r in range(2)]
    return {"ranks": ranks, "tree": tree, "xes": xes, "cs": cs,
            "jmodel": jmodel, "key": key}


def test_parameters_stay_replicated(two):
    a, b = two["ranks"]
    assert a["losses"] == b["losses"]
    assert np.isfinite(a["losses"]).all()
    _close(a["params"], b["params"], rtol=0, atol=0)


def test_shard_noise_is_decorrelated(two):
    assert shard_seed(3, 0, 1) == 3
    assert len({shard_seed(3, i, 2) for i in range(2)}) == 2
    tree, xes, cs = two["tree"], two["xes"], two["cs"]
    half = B // 2
    model = _port(tree)
    seed = shard_seed(11, 0, 2)
    eps = torch.randn((1, half, Z),
                      generator=torch.Generator().manual_seed(seed))
    xs = [torch.from_numpy(x[None, :half]) for x in xes]
    cc = [torch.from_numpy(c[None, :half]) for c in cs]
    with torch.no_grad():
        half_loss = float(model.loss(xs, model(xs, cc, "poe",
                                               eps=eps))["total"][0])
    dup = two["ranks"][0]["dup"]
    assert dup == two["ranks"][1]["dup"] and np.isfinite(dup)
    assert abs(dup - half_loss) > 1e-6


def test_step_matches_jax_on_replayed_fold_in_draws(two):
    import jax
    import optax

    from multi_modal_normative_modeling_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh,
    )
    from multi_modal_normative_modeling_tpu.parallel.shardmap_step import (
        build_dp_step_shardmap as jax_step,
    )

    opt = optax.adam(LR)
    mesh = jax_make_mesh(1, 2, devices=jax.devices()[:2])
    step = jax_step(two["jmodel"], opt, "poe", mesh)
    params, _, loss = step(two["tree"], opt.init(two["tree"]),
                           tuple(two["xes"]), tuple(two["cs"]), two["key"])
    for res in two["ranks"]:
        np.testing.assert_allclose(res["replay_loss"], float(loss),
                                   rtol=1e-5)
        _close(res["replay_params"],
               jax.tree_util.tree_map(np.asarray, params), rtol=1e-5,
               atol=1e-6)
