"""The port's ops (linear, LeakyReLU, the six fusion functions) against the
JAX package's on the same numpy-seeded inputs. Tolerance rtol/atol 1e-6:
the same fp32 elementwise math, summed over at most 5 experts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_normative_modeling_tpu.ops import fusion as jfusion
from multi_modal_normative_modeling_tpu.ops import linear as jlinear
from multi_modal_normative_modeling_tpu_torch.ops import fusion as tfusion
from multi_modal_normative_modeling_tpu_torch.ops import linear as tlinear
from tests.test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("b,fan_in,fan_out", [(7, 119, 110), (64, 110, 10),
                                              (3, 3487, 110)])
def test_apply_linear_matches_jax(b, fan_in, fan_out):
    rng = np.random.default_rng(fan_in)
    layer = jlinear.init_linear(jax.random.PRNGKey(0), fan_in, fan_out)
    w = np.asarray(layer["w"])
    x = rng.standard_normal((b, fan_in)).astype(np.float32)
    ref = jlinear.apply_linear(layer, jnp.asarray(x))
    port = tlinear.apply_linear(torch.from_numpy(w.T.copy()),
                                torch.from_numpy(np.array(layer["b"])),
                                torch.from_numpy(x))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_apply_linear_fold_axis_is_per_fold():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 5, 8)).astype(np.float32)
    b = rng.standard_normal((3, 5)).astype(np.float32)
    x = rng.standard_normal((3, 4, 8)).astype(np.float32)
    port = tlinear.apply_linear(torch.from_numpy(w), torch.from_numpy(b),
                                torch.from_numpy(x))
    for f in range(3):
        np.testing.assert_allclose(port[f].numpy(), x[f] @ w[f].T + b[f],
                                   rtol=1e-6, atol=1e-6)


def test_leaky_relu_matches_jax():
    x = np.random.default_rng(0).standard_normal((16, 33)).astype(np.float32)
    _close(tlinear.leaky_relu(torch.from_numpy(x)),
           jlinear.leaky_relu(jnp.asarray(x)))


def test_init_linear_bounds_and_seed():
    gen = torch.Generator().manual_seed(5)
    w, b = tlinear.init_linear(100, 7, folds=2, generator=gen)
    assert w.shape == (2, 7, 100) and b.shape == (2, 7)
    assert w.abs().max() <= 0.1 and b.abs().max() <= 0.1
    w2, _ = tlinear.init_linear(100, 7, folds=2,
                                generator=torch.Generator().manual_seed(5))
    assert torch.equal(w, w2)


def _experts(m, seed=0, b=9, z=10):
    rng = np.random.default_rng(seed + m)
    mus = rng.standard_normal((m, b, z)).astype(np.float32)
    logvars = rng.standard_normal((m, b, z)).astype(np.float32)
    alpha = rng.standard_normal((m,)).astype(np.float32)
    return mus, np.exp(logvars), logvars, alpha


def _pair(port, ref):
    _close(port[0], ref[0])
    _close(port[1], ref[1])


@pytest.mark.parametrize("m", [1, 2, 4])
def test_product_of_experts(m):
    mus, var, _, _ = _experts(m)
    _pair(tfusion.product_of_experts(torch.from_numpy(mus),
                                     torch.from_numpy(var)),
          jfusion.product_of_experts(jnp.asarray(mus), jnp.asarray(var)))


@pytest.mark.parametrize("m", [1, 2, 4])
def test_gpoe(m):
    mus, var, _, alpha = _experts(m)
    _pair(tfusion.gpoe(torch.from_numpy(mus), torch.from_numpy(var),
                       torch.from_numpy(alpha)),
          jfusion.gpoe(jnp.asarray(mus), jnp.asarray(var),
                       jnp.asarray(alpha)))


@pytest.mark.parametrize("m", [1, 2, 4])
def test_mixture_of_experts(m):
    mus, var, _, _ = _experts(m)
    _pair(tfusion.mixture_of_experts(torch.from_numpy(mus),
                                     torch.from_numpy(var)),
          jfusion.mixture_of_experts(jnp.asarray(mus), jnp.asarray(var)))


@pytest.mark.parametrize("m", [1, 2, 4])
def test_mixture_of_product_of_experts(m):
    mus, var, _, _ = _experts(m)
    _pair(tfusion.mixture_of_product_of_experts(torch.from_numpy(mus),
                                                torch.from_numpy(var)),
          jfusion.mixture_of_product_of_experts(jnp.asarray(mus),
                                                jnp.asarray(var)))


@pytest.mark.parametrize("m", [1, 2, 4])
def test_poe_logvar(m):
    mus, _, logvars, _ = _experts(m)
    _pair(tfusion.poe_logvar(torch.from_numpy(mus),
                             torch.from_numpy(logvars)),
          jfusion.poe_logvar(jnp.asarray(mus), jnp.asarray(logvars)))


@pytest.mark.parametrize("combine", ["poe", "gPoE", "moe", "MoPoE"])
@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("shortcut", [True, False])
def test_combine_latent(combine, m, shortcut):
    mus, var, _, alpha = _experts(m)
    _pair(tfusion.combine_latent(torch.from_numpy(mus), torch.from_numpy(var),
                                 combine, torch.from_numpy(alpha),
                                 single_modality_shortcut=shortcut),
          jfusion.combine_latent(jnp.asarray(mus), jnp.asarray(var), combine,
                                 jnp.asarray(alpha),
                                 single_modality_shortcut=shortcut))


def test_combine_latent_errors():
    mus, var, _, _ = _experts(2)
    with pytest.raises(ValueError, match="alpha"):
        tfusion.combine_latent(torch.from_numpy(mus), torch.from_numpy(var),
                               "gpoe")
    with pytest.raises(ValueError, match="No such combination"):
        tfusion.combine_latent(torch.from_numpy(mus), torch.from_numpy(var),
                               "sum")


@pytest.mark.parametrize("m", [2, 4])
def test_gpoe_fold_axis_matches_per_fold_jax(m):
    """Fold-stacked statistics [M, F, B, Z] with alpha [F, M] fuse each fold
    with its own weights."""
    folds = 3
    per_fold = [_experts(m, seed=10 * f) for f in range(folds)]
    mus = np.stack([p[0] for p in per_fold], axis=1)
    var = np.stack([p[1] for p in per_fold], axis=1)
    alpha = np.stack([p[3] for p in per_fold])
    port_mu, port_var = tfusion.gpoe(torch.from_numpy(mus),
                                     torch.from_numpy(var),
                                     torch.from_numpy(alpha))
    for f, (fm, fv, _, fa) in enumerate(per_fold):
        ref_mu, ref_var = jfusion.gpoe(jnp.asarray(fm), jnp.asarray(fv),
                                       jnp.asarray(fa))
        _close(port_mu[f], ref_mu)
        _close(port_var[f], ref_var)
