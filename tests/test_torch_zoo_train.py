"""The zoo's training trajectories against the JAX package's, on the CPU.

Two folds of different sizes (37 and 21 subjects in batches of 16, so the
small fold meets an all-padding last batch every epoch) train 4 epochs in
the port's ``MultiFoldTrainer`` and in JAX ``MultiFoldTrainer`` from the same
JAX init and the same noise (``tests.test_torch_train.jax_eps_replay`` at the
model's ``noise_dim``: the shared code's width for the DMVAE family, zero
when it is empty). mvtCAE's total-correlation term is infinite on the
all-padding batch and its gradient NaN; both trainers drop that fold's step.

Bounds, those of tests/test_torch_train.py: every logged term within rtol
1e-4, parameters within rtol 5e-3 / atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from multi_modal_normative_modeling_tpu_torch.parallel import (
    MultiFoldTrainer,
    stack_fold_batches,
)
from multi_modal_normative_modeling_tpu_torch.train import (
    TrainConfig,
    default_loss_fn,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_train import jax_eps_replay
from tests.test_torch_zoo import C, DIMS, close_trees, make_pair

EPOCHS, BATCH = 4, 16
SIZES = (37, 21)

# name -> (registry name or skeleton variant, latent dim, combine, extras)
CASES = {
    "mmJSD": ("mmJSD", 6, "poe", {}),
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


def _cohort(rng, n):
    data = [rng.standard_normal((n, d)).astype(np.float32) for d in DIMS]
    return data, [rng.standard_normal((n, C)).astype(np.float32)] * len(DIMS)


@pytest.mark.parametrize("case", CASES)
def test_ragged_two_fold_trajectory_matches_jax(case):
    name, z, combine, extra = CASES[case]
    jmodel, trees, model = make_pair(name, z, extra, folds=2, seed=3)
    # every fold starts from the same tree, as the CLI starts them
    tree = trees[0]
    params_from_jax(jax_stack_params([tree, tree]), model)

    rng = np.random.default_rng(3)
    cohorts = [_cohort(rng, n) for n in SIZES]
    data, cov = [c[0] for c in cohorts], [c[1] for c in cohorts]

    jconfig = JaxConfig(epochs=EPOCHS, batch_size=BATCH, combine=combine)
    key = jax.random.PRNGKey(42)
    ref_params, ref_logs = JaxMultiFoldTrainer(
        jmodel, jconfig, max(SIZES)).run(
            jax_stack_params([tree, tree]),
            jax.device_put(jax_stack_fold_batches(data, cov, BATCH)),
            jnp.stack([key, key]))

    config = TrainConfig(epochs=EPOCHS, batch_size=BATCH, combine=combine)
    batches = stack_fold_batches(data, cov, BATCH)
    assert batches["valid"].tolist() == [[True] * 3, [True, True, False]]
    logs = MultiFoldTrainer(model, config, max(SIZES)).run(
        batches, eps=jax_eps_replay(batches["valid"], EPOCHS, BATCH,
                                    model.noise_dim))

    assert set(logs) == set(ref_logs) == set(model.log_keys)
    for k in model.log_keys:
        assert logs[k].shape == (2, EPOCHS)
        assert np.isfinite(logs[k]).all()
        np.testing.assert_allclose(logs[k], np.asarray(ref_logs[k]),
                                   rtol=1e-4, err_msg=k)
    got = params_to_jax(model)
    for leaf in jax.tree_util.tree_leaves(got):
        assert np.isfinite(leaf).all()
    close_trees(got, jax.tree_util.tree_map(np.asarray, ref_params),
                rtol=5e-3, atol=1e-5)


@pytest.mark.parametrize("case", ["mvtCAE-poe", "DMVAE-empty-shared"])
def test_the_all_padding_step_leaves_its_fold_untouched(case):
    """One step on a batch that is all padding in fold 1: fold 1's
    parameters do not move, whatever its loss and gradient are (NaN for
    mvtCAE), and fold 0 takes its step."""
    name, z, combine, extra = CASES[case]
    _, _, model = make_pair(name, z, extra, folds=2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(5)
    cohorts = [_cohort(rng, 8), _cohort(rng, 8)]
    batches = stack_fold_batches([c[0] for c in cohorts],
                                 [c[1] for c in cohorts], 8)
    batches["mask"][1] = 0.0
    batches["valid"][1] = False
    config = TrainConfig(epochs=1, batch_size=8, combine=combine)
    eps = np.zeros((1, 2, 8, model.noise_dim), np.float32)
    loss_fn = default_loss_fn(model, config)
    total, _ = loss_fn(
        {"x": [torch.from_numpy(x[:, 0]) for x in batches["x"]],
         "c": [torch.from_numpy(c[:, 0]) for c in batches["c"]],
         "mask": torch.from_numpy(batches["mask"][:, 0])},
        torch.from_numpy(eps[0]))
    assert torch.isfinite(total[0])
    if name == "mvtCAE":
        assert not torch.isfinite(total[1])
    MultiFoldTrainer(model, config, 8).run(batches, eps=eps)
    moved = 0
    for k, v in model.state_dict().items():
        assert torch.isfinite(v).all(), k
        assert torch.equal(v[1], before[k][1]), k
        moved += int(not torch.equal(v[0], before[k][0]))
    assert moved > 0
