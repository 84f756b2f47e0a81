"""The port's top-level facade and its one-fold library API against the JAX
package's, on the CPU.

Every name of the JAX facade's ``__all__`` resolves in the port, to the
port's own implementation, and a bare import of the port imports nothing
heavy. ``FoldTrainer`` (a thin class over ``MultiFoldTrainer`` at F = 1)
and ``train_single_fold`` train one small fold (3 modalities of 24, 40 and
16 features, 37 subjects in batches of 16, the last ragged) from the JAX
init with JAX's noise replayed: logs rtol 1e-4, parameters rtol 5e-3 /
atol 1e-5, the JAX trainer's trajectory bounds (tests/test_torch_train.py).
A resumable run in chunks, or killed and resumed, equals the straight run
bit for bit. ``load_checkpoint`` on a JAX-written checkpoint equals JAX's
``load_checkpoint`` leaf for leaf and refuses an orbax directory.
"""
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import multi_modal_normative_modeling_tpu as jax_pkg
import multi_modal_normative_modeling_tpu_torch as port
from multi_modal_normative_modeling_tpu.models import build_model as jax_build
from multi_modal_normative_modeling_tpu.train import (
    FoldTrainer as JaxFoldTrainer,
    TrainConfig as JaxConfig,
)
from multi_modal_normative_modeling_tpu.train.checkpoints import (
    load_checkpoint as jax_load_checkpoint,
    save_checkpoint as jax_save_checkpoint,
)
from multi_modal_normative_modeling_tpu_torch.interop import (
    params_from_jax,
    params_to_jax,
)
from multi_modal_normative_modeling_tpu_torch.models import build_model
from multi_modal_normative_modeling_tpu_torch.parallel import (
    MultiFoldTrainer,
    stack_fold_batches,
)
from multi_modal_normative_modeling_tpu_torch.train import (
    FoldTrainer,
    TrainConfig,
    load_checkpoint,
    save_checkpoint,
    train_single_fold,
)
from multi_modal_normative_modeling_tpu_torch.train.checkpoints import (
    _state_dict,
)
from multi_modal_normative_modeling_tpu_torch.train.trainer import (
    FoldNoise,
    ReplayNoise,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_train import jax_eps_replay

DIMS = [24, 40, 16]
HIDDEN = [12, 12]
Z, C = 6, 5
N, BATCH, EPOCHS = 37, 16, 4
LOG_TOL = dict(rtol=1e-4)
PARAM_TOL = dict(rtol=5e-3, atol=1e-5)
PORT = port.__name__


def _cohort(seed=0):
    rng = np.random.default_rng(seed)
    data = [rng.standard_normal((N, d)).astype(np.float32) for d in DIMS]
    return data, [rng.standard_normal((N, C)).astype(np.float32)] * len(DIMS)


def _jax_tree(seed=0):
    model = jax_build("cVAE_multimodal", DIMS, HIDDEN, Z, C, len(DIMS))
    return model, jax.tree_util.tree_map(
        np.asarray, model.init_params(jax.random.PRNGKey(seed)))


def _port_model(tree=None):
    model = build_model("cVAE_multimodal", DIMS, HIDDEN, Z, C, len(DIMS),
                        folds=1)
    if tree is not None:
        params_from_jax(tree, model)
    return model


def _config(epochs=EPOCHS):
    return TrainConfig(epochs=epochs, batch_size=BATCH)


def _replay():
    nb = -(-N // BATCH)
    return jax_eps_replay(np.ones((1, nb), bool), EPOCHS, BATCH, Z)


def _leaves_close(got, want, **tol):
    a, b = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.shape(x) == np.shape(y)
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), **tol)


def _leaves_equal(got, want):
    a, b = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))


# ---- the facade ------------------------------------------------------------


@pytest.mark.parametrize("name", jax_pkg.__all__)
def test_every_jax_public_name_resolves_to_the_port(name):
    obj = getattr(port, name)
    where = obj.__name__ if name in port._SUBMODULES else obj.__module__
    assert where == PORT or where.startswith(PORT + "."), (name, where)
    assert name in port.__all__ and name in dir(port)


def test_the_facade_points_at_the_counterparts():
    from multi_modal_normative_modeling_tpu_torch.infer import (
        deviation,
        emitters,
        ensemble,
    )
    from multi_modal_normative_modeling_tpu_torch.parallel import (
        mesh,
        tensor,
    )
    from multi_modal_normative_modeling_tpu_torch.train import (
        checkpoints,
        trainer,
    )

    assert port.FoldTrainer is trainer.FoldTrainer is FoldTrainer
    assert port.train_single_fold is trainer.train_single_fold
    assert port.load_checkpoint is checkpoints.load_checkpoint
    assert port.load_ensemble is ensemble.load_ensemble
    assert port.make_mesh is mesh.make_mesh
    assert port.make_mesh3 is tensor.make_mesh3
    assert port.reconstruction_deviation is deviation.reconstruction_deviation
    assert port.DeviationEmitter is emitters.DeviationEmitter
    assert port.get_hc_label("ADNI") == jax_pkg.get_hc_label("ADNI") == 2
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        port.nope


def test_bare_import_stays_light():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import multi_modal_normative_modeling_tpu_torch\n"
        "new = set(sys.modules) - before\n"
        "heavy = [m for m in ('jax', 'numpy', 'pandas', 'torch',\n"
        "                     'matplotlib', 'scipy', 'sklearn')\n"
        "         if m in new]\n"
        "assert not heavy, f'bare import pulled {heavy}'\n"
        "print('light')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "light" in out.stdout


# ---- FoldTrainer and train_single_fold against JAX's -----------------------


@pytest.fixture(scope="module")
def jax_run():
    data, covs = _cohort()
    model, tree = _jax_tree()
    trainer = JaxFoldTrainer(model, JaxConfig(epochs=EPOCHS,
                                              batch_size=BATCH), N)
    params, logs = trainer.run(tree, data, covs)
    return tree, jax.tree_util.tree_map(np.asarray, params), logs


def test_fold_trainer_run_matches_jax(jax_run):
    tree, ref_params, ref_logs = jax_run
    data, covs = _cohort()
    trainer = FoldTrainer(_port_model(), _config(), N)
    params, logs = trainer.run(tree, data, covs,
                               noise=ReplayNoise(_replay(), "cpu"))
    assert sorted(logs) == sorted(ref_logs)
    for k in logs:
        assert logs[k].shape == (EPOCHS,)
        np.testing.assert_allclose(logs[k], np.asarray(ref_logs[k]),
                                   err_msg=k, **LOG_TOL)
    _leaves_close(params, ref_params, **PARAM_TOL)


def test_train_single_fold_matches_jax(jax_run):
    tree, ref_params, ref_logs = jax_run
    data, covs = _cohort()
    params, logs = train_single_fold(_port_model(), tree, data, covs,
                                     _config(),
                                     noise=ReplayNoise(_replay(), "cpu"))
    _leaves_close(params, ref_params, **PARAM_TOL)
    np.testing.assert_allclose(logs["total"], np.asarray(ref_logs["total"]),
                               **LOG_TOL)


def test_a_shared_trainer_takes_each_calls_params(jax_run):
    """JAX's FoldTrainer is pure: each run starts from the params it is
    given. The port's loads them into its model first, so a second run
    from the same params repeats the first."""
    tree, _, _ = jax_run
    data, covs = _cohort()
    model = _port_model()
    trainer = FoldTrainer(model, _config(), N)
    first = train_single_fold(model, tree, data, covs, _config(),
                              trainer=trainer)
    again = train_single_fold(model, tree, data, covs, _config(),
                              trainer=trainer)
    _leaves_equal(first[0], again[0])
    _leaves_equal(first[1], again[1])


def test_fold_trainer_is_multi_fold_trainer_at_one_fold():
    _, tree = _jax_tree(seed=3)
    data, covs = _cohort(seed=3)
    config = _config()
    params, logs = FoldTrainer(_port_model(), config, N).run(tree, data,
                                                             covs)
    model = _port_model(tree)
    ref_logs = MultiFoldTrainer(model, config, N).run(
        stack_fold_batches([data], [covs], BATCH))
    _leaves_equal(params, params_to_jax(model, fold=0))
    for k in ref_logs:
        assert np.array_equal(logs[k], ref_logs[k][0])


@pytest.mark.parametrize("noise", ["generator", "fold_noise"])
def test_noise_sources_draw_the_default_stream(noise):
    """None draws from a generator seeded config.seed (42); a generator or
    a FoldNoise seeded alike draw the same stream."""
    _, tree = _jax_tree(seed=4)
    data, covs = _cohort(seed=4)
    ref = FoldTrainer(_port_model(), _config(), N).run(tree, data, covs)
    source = {"generator": torch.Generator().manual_seed(42),
              "fold_noise": FoldNoise(1, (BATCH, Z), 42, "cpu")}[noise]
    got = FoldTrainer(_port_model(), _config(), N).run(tree, data, covs,
                                                       noise=source)
    _leaves_equal(got[0], ref[0])
    _leaves_equal(got[1], ref[1])


def test_run_resumable_equals_the_straight_run(tmp_path):
    _, tree = _jax_tree(seed=5)
    data, covs = _cohort(seed=5)
    straight = FoldTrainer(_port_model(), _config(), N).run(
        tree, data, covs, noise=torch.Generator().manual_seed(7))
    chunked = FoldTrainer(_port_model(), _config(), N).run_resumable(
        tree, data, covs, torch.Generator().manual_seed(7),
        tmp_path / "chunked", checkpoint_every=3)
    # killed after epoch 2, then resumed in a fresh trainer and model
    FoldTrainer(_port_model(), _config(epochs=2), N).run_resumable(
        tree, data, covs, torch.Generator().manual_seed(7),
        tmp_path / "killed", checkpoint_every=1)
    resumed_trainer = FoldTrainer(_port_model(), _config(), N)
    resumed = resumed_trainer.run_resumable(
        None, data, covs, torch.Generator().manual_seed(7),
        tmp_path / "killed", checkpoint_every=1)
    assert resumed_trainer.engine.resumed_from == 2
    for got in (chunked, resumed):
        _leaves_equal(got[0], straight[0])
        _leaves_equal(got[1], straight[1])


def test_init_opt_state_is_a_fresh_adam():
    _, tree = _jax_tree(seed=6)
    model = _port_model()
    adam = FoldTrainer(model, _config(), N).init_opt_state(tree)
    assert adam.count.shape == (1,) and not adam.count.any()
    assert not adam.m.any() and not adam.v.any()
    _leaves_equal(params_to_jax(model, fold=0), tree)


def test_fold_trainer_refuses_another_noise_source():
    _, tree = _jax_tree()
    data, covs = _cohort()
    with pytest.raises(TypeError, match="not int"):
        FoldTrainer(_port_model(), _config(), N).run(tree, data, covs,
                                                     noise=42)


def test_fold_trainer_refuses_a_stacked_model():
    model = build_model("cVAE_multimodal", DIMS, HIDDEN, Z, C, len(DIMS),
                        folds=2)
    with pytest.raises(ValueError, match="trains one fold; the model holds 2"):
        FoldTrainer(model, _config(), N)


# ---- load_checkpoint -------------------------------------------------------


def test_load_checkpoint_of_a_jax_checkpoint_equals_jax(tmp_path):
    _, tree = _jax_tree(seed=8)
    config = {"model": "cVAE_multimodal", "input_dim_list": DIMS}
    jax_save_checkpoint(tmp_path, tree, config)
    ref, ref_config = jax_load_checkpoint(tmp_path)
    got, got_config = load_checkpoint(tmp_path)
    assert got_config == ref_config == config
    # JAX without a template returns the raw state dict (lists as dicts
    # keyed "0", "1", ...); the port's lists, as flax saved them
    raw = _state_dict(got)

    def same(a, b):
        if isinstance(b, dict):
            assert isinstance(a, dict) and sorted(a) == sorted(b)
            for k in b:
                same(a[k], b[k])
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b)

    same(raw, ref)
    ref_t, _ = jax_load_checkpoint(tmp_path, template_params=tree)
    got_t, _ = load_checkpoint(tmp_path, template_params=tree)
    _leaves_equal(got_t, ref_t)
    assert (jax.tree_util.tree_structure(got_t)
            == jax.tree_util.tree_structure(ref_t))


def test_load_checkpoint_reads_what_the_port_saved(tmp_path):
    model = _port_model()
    tree = params_to_jax(model, fold=0)
    save_checkpoint(tmp_path, tree, {"latent_dim": Z})
    got, config = load_checkpoint(tmp_path, template_params=tree)
    assert config == {"latent_dim": Z}
    _leaves_equal(got, tree)
    ref, _ = jax_load_checkpoint(tmp_path, template_params=tree)
    _leaves_equal(got, ref)


def test_load_checkpoint_reports_a_torn_pair(tmp_path):
    _, tree = _jax_tree(seed=9)
    jax_save_checkpoint(tmp_path, tree, {})
    other = build_model("cVAE_multimodal", DIMS, [12], Z, C, len(DIMS),
                        folds=1)
    with pytest.raises(ValueError, match="does not match its cVAE_model.json"):
        load_checkpoint(tmp_path, template_params=params_to_jax(other, 0))


def test_load_checkpoint_refuses_orbax(tmp_path):
    _, tree = _jax_tree(seed=10)
    jax_save_checkpoint(tmp_path, tree, {})
    (tmp_path / "cVAE_model.orbax").mkdir()
    with pytest.raises(ValueError, match="orbax checkpoint.*stated "
                                         "divergence"):
        load_checkpoint(tmp_path)
    assert port.checkpoint_exists(tmp_path)
