"""The port's ('fold', 'data') mesh (parallel/mesh.py, parallel/folds.py on a
mesh), on the CPU.

In-process: the fold and row ranges of every rank, ``infer_row_tile``
against the JAX function, every ``parse_*mesh`` message against the JAX
function's on the same spec, and ``shard_batches``. Then two spawns of
ranks (gloo on 127.0.0.1), each rank running several checks of
``MultiFoldTrainer`` against the unmeshed run of the same batches and
noise: a world of two (the data axis on ragged masks, the fold axis, the
DMVAE family, resume, the masked means' denominators) and a world of four
(2,2 and 1,4). Training bounds rtol 2e-4 / atol 2e-5, the JAX tests'
(tests/test_tensor_parallel.py, tests/test_fold_parallel_cli.py)."""
import argparse
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from multi_modal_normative_modeling_tpu_torch.cli import common
from multi_modal_normative_modeling_tpu_torch.models import build_model
from multi_modal_normative_modeling_tpu_torch.ops import losses
from multi_modal_normative_modeling_tpu_torch.parallel import (
    MultiFoldTrainer,
    stack_fold_batches,
)
from multi_modal_normative_modeling_tpu_torch.parallel.mesh import (
    Mesh,
    fold_data_shardings,
    fold_range,
    make_mesh,
    row_range,
    shard_batches,
)
from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
from multi_modal_normative_modeling_tpu_torch.train.checkpoints import (
    load_train_state,
)
from tests.test_torch_mesh_cli import join_world, rendezvous
from tests.test_torch_threads import one_torch_thread  # noqa: F401

DIMS, HIDDEN, Z, C = [9, 7], [16, 16], 4, 3
TOL = dict(rtol=2e-4, atol=2e-5)


# ---- plans (in-process) ----------------------------------------------------

@pytest.mark.parametrize("shape", [{"fold": 2, "data": 1},
                                   {"fold": 1, "data": 2},
                                   {"fold": 2, "data": 2},
                                   {"fold": 1, "data": 4}])
def test_every_rank_holds_its_folds_and_rows(shape):
    size = int(np.prod(list(shape.values())))
    held = set()
    for rank in range(size):
        mesh = Mesh(shape, rank)
        f0, f1 = fold_range(mesh, 4)
        r0, r1 = row_range(mesh, 8)
        assert f1 - f0 == 4 // shape["fold"]
        assert r1 - r0 == 8 // shape["data"]
        assert (f0 // (f1 - f0), r0 // (r1 - r0)) == (
            mesh.coords["fold"], mesh.coords["data"])
        assert fold_data_shardings(mesh, 4, 8)[:2] == ((f0, f1), (r0, r1))
        held |= {(f, r) for f in range(f0, f1) for r in range(r0, r1)}
    assert held == {(f, r) for f in range(4) for r in range(8)}
    with pytest.raises(ValueError, match="not divisible"):
        fold_range(Mesh({"fold": 3, "data": 1}, 0), 4)


@pytest.mark.parametrize("n_data", [1, 2, 3, 4, 8])
def test_infer_row_tile_matches_jax(n_data):
    import jax

    from multi_modal_normative_modeling_tpu.cli import common as jcommon
    from multi_modal_normative_modeling_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh,
    )

    jmesh = jax_make_mesh(1, n_data, devices=jax.devices()[:n_data])
    mesh = Mesh({"fold": 1, "data": n_data}, 0)
    assert common.infer_row_tile(mesh) == jcommon.infer_row_tile(jmesh)
    assert common.infer_row_tile() == jcommon.infer_row_tile(None) == 64
    assert common.padded_rows(65, mesh) % common.infer_row_tile(mesh) == 0


MESH_SPECS = [("3,5", 3, 256), ("-2,-4", 10, 256), ("a,b", 2, 256),
              ("1,2,3,4", 2, 256), ("4,2", 3, 256), ("2,4", 2, 5),
              ("8", 2, 256), ("1,8,1", 2, 6)]
INFER_SPECS = ["3,5", "-1,8", "1", "a", "1,2,3,4"]
SWEEP_SPECS = [("3,5", 2, 2), ("4,2", 3, 2), ("2,4", 2, 3), ("8", 2, 2),
               ("a", 2, 2), ("-1,-8", 2, 2)]


def _message(fn, *args):
    with pytest.raises(SystemExit) as info:
        fn(*args)
    return str(info.value)


def test_parse_mesh_messages_match_jax(monkeypatch):
    """The same spec gives the JAX function's message, with the ranks in
    the role of the 8 virtual devices (WORLD_SIZE 8; no spec here reaches
    the process group)."""
    import jax

    from multi_modal_normative_modeling_tpu.cli import common as jcommon

    assert jax.device_count() == 8
    monkeypatch.setenv("WORLD_SIZE", "8")
    for spec, folds, batch in MESH_SPECS:
        assert (_message(common.parse_mesh, spec, folds, batch)
                == _message(jcommon.parse_mesh, spec, folds, batch)), spec
    for spec in INFER_SPECS:
        assert (_message(common.parse_infer_mesh, spec)
                == _message(jcommon.parse_infer_mesh, spec)), spec
    for spec, configs, folds in SWEEP_SPECS:
        assert (_message(common.parse_sweep_mesh, spec, configs, folds)
                == _message(jcommon.parse_sweep_mesh, spec, configs,
                            folds)), spec
    for spec in ("1,2,3", "x"):
        assert (_message(common.parse_axis_sizes, spec, "--ep_mesh", (2,),
                         "2,4")
                == _message(jcommon.parse_axis_sizes, spec, "--ep_mesh",
                            (2,), "2,4")), spec
    args = argparse.Namespace(mesh="2,4", fold_parallel=False)
    assert (_message(common.parse_run_mesh, args, 2, 256)
            == _message(jcommon.parse_run_mesh, args, 2, 256))
    assert common.parse_mesh(None, 2, 256) == (None, None)
    assert common.parse_infer_mesh("") is None


def test_check_infer_fold_axis_matches_jax():
    import jax

    from multi_modal_normative_modeling_tpu.cli import common as jcommon
    from multi_modal_normative_modeling_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh,
    )

    jmesh = jax_make_mesh(2, 1, devices=jax.devices()[:2])
    mesh = Mesh({"fold": 2, "data": 1}, 0)
    assert (_message(common.check_infer_fold_axis, mesh, 3, "folds")
            == _message(jcommon.check_infer_fold_axis, jmesh, 3, "folds"))
    common.check_infer_fold_axis(mesh, 4)
    common.check_infer_fold_axis(None, 3)


def _cohorts(seed=0, ns=(37, 28)):
    rng = np.random.default_rng(seed)
    data = [[rng.normal(size=(n, d)).astype(np.float32) for d in DIMS]
            for n in ns]
    cov = [[rng.normal(size=(n, C)).astype(np.float32)] * len(DIMS)
           for n in ns]
    return data, cov


def test_shard_batches_keeps_the_global_valid_flags_and_counts():
    data, cov = _cohorts()
    batches = stack_fold_batches(data, cov, 8)
    # fold 1: 28 rows, its last batch holds 4 real rows (rank 1's all pad)
    part = shard_batches(batches, fold_data_shardings(
        Mesh({"fold": 1, "data": 2}, 1), 2, 8))
    assert part["mask"].shape == (2, 5, 4)
    assert part["mask"][1, 3].sum() == 0 and part["valid"][1, 3]
    np.testing.assert_array_equal(part["valid"], batches["valid"])
    np.testing.assert_array_equal(part["counts"],
                                  batches["mask"].sum(axis=2))
    np.testing.assert_array_equal(part["x"][0], batches["x"][0][:, :, 4:])
    assert part["row_slice"] == (4, 8, 8)
    assert part["x"][0].flags["C_CONTIGUOUS"]


# ---- ranks -------------------------------------------------------------------

def _model(name="cVAE_multimodal", folds=2):
    return build_model(name, DIMS, HIDDEN, Z, C, len(DIMS), folds=folds,
                       generator=torch.Generator().manual_seed(0))


def _train(mesh=None, name="cVAE_multimodal", epochs=3, bs=8, ns=(37, 28),
           state_dir=None, every=0, resume=False, shuffle=False):
    data, cov = _cohorts(ns=ns)
    batches = stack_fold_batches(data, cov, bs)
    model = _model(name, folds=len(ns))
    trainer = MultiFoldTrainer(model, TrainConfig(epochs=epochs,
                                                  batch_size=bs,
                                                  shuffle=shuffle),
                               max(ns), mesh=mesh)
    if every:
        logs = trainer.run_resumable(batches, state_dir, every, resume)
    else:
        logs = trainer.run(batches)
    return ({n: p.detach().numpy().copy()
             for n, p in model.named_parameters()}, logs)


def _milestones(mesh=None):
    """run_milestones' snapshots (epoch, per-fold JAX-layout trees)."""
    data, cov = _cohorts()
    trainer = MultiFoldTrainer(_model(), TrainConfig(epochs=3, batch_size=8),
                               37, mesh=mesh)
    return [(m, params) for m, params, _ in trainer.run_milestones(
        stack_fold_batches(data, cov, 8), [1, 3])]


def _denominators(mesh, bs=8):
    """The loss of fold 1's ragged last batch (4 real rows: rank 0 holds
    them all) summed over the ranks, with the global row counts and with
    each rank's own, and the unmeshed loss."""
    data, cov = _cohorts()
    batches = stack_fold_batches(data, cov, bs)
    model = _model()
    eps = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, bs, Z)).astype(np.float32))
    step = 3

    def loss(part, eps, counts):
        x = [torch.from_numpy(a[:, step]) for a in part["x"]]
        c = [torch.from_numpy(a[:, step]) for a in part["c"]]
        mask = torch.from_numpy(part["mask"][:, step])
        with torch.no_grad(), losses.global_row_counts(counts):
            fwd = model(x, c, "poe", eps=eps)
            return model.loss(x, fwd, mask)["total"]

    plan = fold_data_shardings(mesh, 2, bs)
    part = shard_batches(batches, plan)
    mine = eps[:, plan.rows[0]:plan.rows[1]]
    glob = mesh.all_reduce_(loss(part, mine, torch.from_numpy(
        part["counts"][:, step])), "data")
    local = mesh.all_reduce_(loss(part, mine, None), "data") / 2
    return glob, local, loss(batches, eps, None)


def _two_ranks(rank, world, store, out):
    join_world(rank, world, store)
    res = {}
    d12 = make_mesh(1, 2)
    f21 = make_mesh(2, 1)
    res["d12"] = _train(d12)
    res["f21"] = _train(f21)
    res["f21_shuffled"] = _train(f21, shuffle=True)
    with pytest.raises(ValueError, match="shuffle"):
        _train(d12, shuffle=True)
    res["dmvae"] = _train(d12, name="WeightedDMVAE")
    res["milestones"] = _milestones(d12)
    res["denominators"] = _denominators(d12)
    # resume on the mesh: killed after 2 of 4 epochs, resumed in place
    state = Path(out).parent / "state"
    res["straight"] = _train(d12, epochs=4)
    _train(d12, epochs=2, state_dir=state, every=1)
    res["resumed"] = _train(d12, epochs=4, state_dir=state, every=1,
                            resume=True)
    with pytest.raises(ValueError, match="mesh"):
        _train(None, epochs=4, state_dir=state, every=1, resume=True)
    res["state"] = str(state)
    if rank == 0:
        Path(out).write_bytes(pickle.dumps(res))


def _four_ranks(rank, world, store, out):
    join_world(rank, world, store)
    res = {"d22": _train(make_mesh(2, 2)),
           "d14": _train(make_mesh(1, 4), bs=12, ns=(37, 26))}
    if rank == 0:
        Path(out).write_bytes(pickle.dumps(res))


def _spawn(fn, world, tmp_path):
    out = tmp_path / "out.pkl"
    mp.spawn(fn, args=(world, rendezvous(tmp_path), str(out)), nprocs=world)
    return pickle.loads(out.read_bytes())


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _spawn(_two_ranks, 2, tmp_path_factory.mktemp("two_ranks"))


def _close(got, want, what):
    params, logs = got
    ref_params, ref_logs = want
    for n in ref_params:
        np.testing.assert_allclose(params[n], ref_params[n],
                                   err_msg=f"{what} {n}", **TOL)
    for k in ref_logs:
        assert logs[k].shape == ref_logs[k].shape
        np.testing.assert_allclose(logs[k], ref_logs[k], err_msg=k, **TOL)


@pytest.mark.parametrize("name", ["d12", "f21"])
def test_meshed_trainer_matches_unmeshed(two, name):
    """Fold 1 (28 rows, batch 8) ends on a batch whose 4 real rows are all
    rank 0's: rank 1 still steps the fold (the global valid flag)."""
    _close(two[name], _train(), name)


@pytest.mark.parametrize("shuffle", [False, True])
def test_fold_axis_is_the_unmeshed_run_bit_for_bit(two, shuffle):
    """Each fold's own rows and noise: on the CPU the split run is the
    unmeshed one bit for bit, with the per-epoch shuffle too (whose
    permuted batches' row counts are the permuted masks')."""
    params, logs = two["f21_shuffled" if shuffle else "f21"]
    ref_params, ref_logs = _train(shuffle=shuffle)
    for n in ref_params:
        np.testing.assert_array_equal(params[n], ref_params[n])


def test_dmvae_family_on_the_data_axis(two):
    _close(two["dmvae"], _train(name="WeightedDMVAE"), "WeightedDMVAE")


def test_ragged_batch_needs_the_global_row_count(two):
    """Summed over the ranks, the loss with the global count is the
    unmeshed batch's; the mean of the ranks' own means is not (rank 1's
    rows of this batch are all padding)."""
    glob, local, want = two["denominators"]
    np.testing.assert_allclose(glob.numpy(), want.numpy(), **TOL)
    assert not np.allclose(local[1].numpy(), want[1].numpy(), rtol=1e-2)
    np.testing.assert_allclose(local[0].numpy(), want[0].numpy(), **TOL)


def test_meshed_resume_equals_the_straight_meshed_run(two, tmp_path):
    params, logs = two["resumed"]
    ref_params, ref_logs = two["straight"]
    for n in ref_params:
        np.testing.assert_array_equal(params[n], ref_params[n])
    for k in ref_logs:
        np.testing.assert_array_equal(logs[k], ref_logs[k])


def test_meshed_train_state_has_the_unmeshed_layout(two, tmp_path):
    """Rank 0 wrote the gathered state: the unmeshed run's shapes."""
    tensors, epoch, logs = load_train_state(two["state"])
    _train(None, epochs=4, state_dir=tmp_path, every=4)
    ref, _, ref_logs = load_train_state(tmp_path)
    assert epoch == 4
    for key in ("flat", "m", "v", "count"):
        assert np.shape(tensors["adam"][key]) == np.shape(ref["adam"][key])
    assert len(tensors["noise"]) == len(ref["noise"]) == 2
    np.testing.assert_allclose(tensors["adam"]["flat"], ref["adam"]["flat"],
                               **TOL)
    assert {k: np.shape(v) for k, v in logs.items()} == {
        k: np.shape(v) for k, v in ref_logs.items()}


def test_four_ranks(tmp_path):
    res = _spawn(_four_ranks, 4, tmp_path)
    _close(res["d22"], _train(), "2,2")
    _close(res["d14"], _train(bs=12, ns=(37, 26)), "1,4")


def test_meshed_milestones_match_unmeshed(two):
    """Each milestone's snapshot is gathered whole from the ranks."""
    got, want = two["milestones"], _milestones()
    assert [m for m, _ in got] == [m for m, _ in want] == [1, 3]
    for (_, g), (_, w) in zip(got, want):
        assert len(g) == len(w) == 2
        for gf, wf in zip(g, w):
            for (pg, a), (pw, b) in zip(_tree_items(gf), _tree_items(wf)):
                assert pg == pw
                np.testing.assert_allclose(a, b, err_msg=pg, **TOL)


def _tree_items(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_items(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_items(v, f"{path}/{i}")
    else:
        yield path, np.asarray(tree)
