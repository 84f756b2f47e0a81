"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain torch version; the Pallas
kernels run in interpret mode, as tests/test_kernels.py runs them. Inputs
are made with numpy from a seed. Tolerance rtol/atol 1e-5, the bound of
tests/test_kernels.py. The CUDA kernels themselves are held against the
plain versions on the card (tests marked ``cuda``, and chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_normative_modeling_tpu.kernels import (
    fused_decoder_mean as jax_fused_decoder_mean,
    fused_encoder as jax_fused_encoder,
    fused_pred_deviation as jax_fused_pred_deviation,
)
from multi_modal_normative_modeling_tpu.models.cvae import (
    apply_decoder,
    apply_encoder,
    init_decoder,
    init_encoder,
)
from multi_modal_normative_modeling_tpu_torch import kernels
from multi_modal_normative_modeling_tpu_torch.kernels import _build, mlp
from tests.test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = [(7, 90, 29), (300, 270, 29), (16, 3485, 2)]
HIDDEN = [[110, 110], [110], [64, 110, 32]]
# the encoder also without a hidden layer (the heads read [x | c]) and with
# hidden layers wider than one 128-column block of its kernel
ENCODER_HIDDEN = HIDDEN + [[], [460, 130]]


def _layer(*per_fold):
    """Fold-stacked port operands of JAX layers {"w" [in, out], "b"}."""
    w = np.stack([np.asarray(p["w"]).T for p in per_fold])
    b = np.stack([np.asarray(p["b"]) for p in per_fold])
    return torch.from_numpy(w.copy()), torch.from_numpy(b.copy())


def _enc_operands(*params):
    hidden = [_layer(*[p["hidden"][i] for p in params])
              for i in range(len(params[0]["hidden"]))]
    return (hidden, _layer(*[p["mu"] for p in params]),
            _layer(*[p["logvar"] for p in params]))


def _dec_operands(*params):
    hidden = [_layer(*[p["hidden"][i] for p in params])
              for i in range(len(params[0]["hidden"]))]
    return hidden, _layer(*[p["mean"] for p in params])


def _rows(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("hidden", ENCODER_HIDDEN)
@pytest.mark.parametrize("b,d,c_dim", SHAPES)
def test_encoder_reference_matches_jax(b, d, c_dim, hidden):
    params = init_encoder(jax.random.PRNGKey(0), d, hidden, 10, c_dim)
    rng = np.random.default_rng(b + d)
    x, c = _rows(rng, b, d), _rows(rng, b, c_dim)

    mu_ref, lv_ref = apply_encoder(params, jnp.asarray(x), jnp.asarray(c),
                                   non_linear=True)
    mu_pl, lv_pl = jax_fused_encoder(params, jnp.asarray(x), jnp.asarray(c),
                                     non_linear=True, interpret=True)
    mu, lv = kernels.encoder_reference(
        *_enc_operands(params), torch.from_numpy(x[None]),
        torch.from_numpy(c[None]), True)
    for port, refs in ((mu[0], (mu_ref, mu_pl)), (lv[0], (lv_ref, lv_pl))):
        for ref in refs:
            np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("hidden", HIDDEN)
@pytest.mark.parametrize("b,d,c_dim", SHAPES)
def test_pred_deviation_reference_matches_jax(b, d, c_dim, hidden):
    params = init_decoder(jax.random.PRNGKey(1), d, hidden, 10, c_dim)
    rng = np.random.default_rng(b * d)
    z, c, x = _rows(rng, b, 10), _rows(rng, b, c_dim), _rows(rng, b, d)

    mean_ref, _ = apply_decoder(params, jnp.asarray(z), jnp.asarray(c),
                                non_linear=True)
    dev_ref = np.sum((x - np.asarray(mean_ref)) ** 2, axis=1) / d
    recon_pl, dev_pl = jax_fused_pred_deviation(
        params, jnp.asarray(z), jnp.asarray(c), jnp.asarray(x),
        non_linear=True, interpret=True)
    recon, dev = kernels.pred_deviation_reference(
        *_dec_operands(params), torch.from_numpy(z[None]),
        torch.from_numpy(c[None]), torch.from_numpy(x[None]), True)
    for ref in (mean_ref, recon_pl):
        np.testing.assert_allclose(recon[0].numpy(), np.asarray(ref), **TOL)
    for ref in (dev_ref, dev_pl):
        np.testing.assert_allclose(dev[0].numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("non_linear", [True, False])
@pytest.mark.parametrize("hidden", HIDDEN)
@pytest.mark.parametrize("b,d,c_dim", SHAPES)
def test_decoder_mean_matches_jax(b, d, c_dim, hidden, non_linear):
    """K3: the wrapper on CPU tensors (its plain version) against JAX
    fused_decoder_mean in interpret mode and apply_decoder's mean, with
    two folds (the second the first's params on other rows)."""
    params = init_decoder(jax.random.PRNGKey(2), d, hidden, 10, c_dim)
    rng = np.random.default_rng(b + 3 * d)
    z, c = _rows(rng, 2, b, 10), _rows(rng, 2, b, c_dim)
    kernels.reset_launch_counts()
    mean = kernels.fused_decoder_mean(
        *_dec_operands(params, params), torch.from_numpy(z),
        torch.from_numpy(c), non_linear)
    assert kernels.fused_decoder_mean.launches == 0
    for f in range(2):
        mean_ref, _ = apply_decoder(params, jnp.asarray(z[f]),
                                    jnp.asarray(c[f]), non_linear=non_linear)
        mean_pl = jax_fused_decoder_mean(params, jnp.asarray(z[f]),
                                         jnp.asarray(c[f]),
                                         non_linear=non_linear,
                                         interpret=True)
        for ref in (mean_ref, mean_pl):
            np.testing.assert_allclose(mean[f].numpy(), np.asarray(ref),
                                       **TOL)


@pytest.mark.parametrize("non_linear", [True, False])
def test_wrappers_run_plain_versions_per_fold_on_cpu(non_linear):
    """Fold-stacked operands: every fold matches the JAX function on that
    fold's params; on CPU tensors the wrappers launch nothing."""
    d, c_dim, b = 90, 29, 21
    enc = [init_encoder(jax.random.PRNGKey(f), d, [110, 110], 10, c_dim)
           for f in range(3)]
    dec = [init_decoder(jax.random.PRNGKey(10 + f), d, [110, 110], 10, c_dim)
           for f in range(3)]
    rng = np.random.default_rng(7)
    x, c, z = _rows(rng, 3, b, d), _rows(rng, 3, b, c_dim), _rows(rng, 3, b, 10)
    kernels.reset_launch_counts()
    mu, lv = kernels.fused_encoder(*_enc_operands(*enc), torch.from_numpy(x),
                                   torch.from_numpy(c), non_linear)
    recon, dev = kernels.fused_pred_deviation(
        *_dec_operands(*dec), torch.from_numpy(z), torch.from_numpy(c),
        torch.from_numpy(x), non_linear)
    assert kernels.fused_encoder.launches == 0
    assert kernels.fused_pred_deviation.launches == 0
    for f in range(3):
        mu_ref, lv_ref = apply_encoder(enc[f], jnp.asarray(x[f]),
                                       jnp.asarray(c[f]), non_linear)
        mean_ref, _ = apply_decoder(dec[f], jnp.asarray(z[f]),
                                    jnp.asarray(c[f]), non_linear)
        np.testing.assert_allclose(mu[f].numpy(), np.asarray(mu_ref), **TOL)
        np.testing.assert_allclose(lv[f].numpy(), np.asarray(lv_ref), **TOL)
        np.testing.assert_allclose(recon[f].numpy(), np.asarray(mean_ref),
                                   **TOL)
        np.testing.assert_allclose(
            dev[f].numpy(),
            np.sum((x[f] - np.asarray(mean_ref)) ** 2, axis=1) / d, **TOL)


def test_wrappers_raise_off_cpu_and_cuda():
    """No silent fallback: a device with neither a kernel nor the plain
    path raises."""
    x = torch.empty(1, 4, 8, device="meta")
    layer = (torch.empty(1, 3, 8, device="meta"),
             torch.empty(1, 3, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        kernels.fused_encoder([], layer, layer, x, x, True)
    with pytest.raises(ValueError, match="no kernel"):
        kernels.fused_pred_deviation([], layer, x, x, x, True)
    with pytest.raises(ValueError, match="no kernel"):
        kernels.fused_decoder_mean([], layer, x, x, True)


def test_operand_checks():
    hidden = [(torch.zeros(2, 110, 119), torch.zeros(2, 110))]
    head = (torch.zeros(2, 10, 110), torch.zeros(2, 10))
    assert _build.chain_widths("k", [*hidden, head, head], 119, 1, 2) == [
        110, 10, 10]
    with pytest.raises(ValueError, match="expected \\[2, n, 120\\]"):
        _build.chain_widths("k", [*hidden, head], 120, 1, 2)
    with pytest.raises(ValueError, match="bias"):
        _build.chain_widths("k", [(torch.zeros(2, 5, 4), torch.zeros(5))], 4,
                            1, 2)
    # what the widths need of shared memory is each kernel's plan to check
    wide = [(torch.zeros(1, 4000, 8), torch.zeros(1, 4000))]
    wide_head = (torch.zeros(1, 10, 4000), torch.zeros(1, 10))
    assert _build.chain_widths("k", [*wide, wide_head, wide_head], 8, 1,
                               1) == [4000, 10, 10]
    with pytest.raises(ValueError, match="shared memory"):
        mlp._prepare("k", [*wide, wide_head, wide_head], 1,
                     torch.zeros(1, 4, 6), torch.zeros(1, 4, 2), None)
    with pytest.raises(ValueError, match="contiguous"):
        _build.check_tensors("k", [torch.zeros(3, 4).T], torch.device("cpu"))
    with pytest.raises(ValueError, match="float32"):
        _build.check_tensors("k", [torch.zeros(3, dtype=torch.float64)],
                             torch.device("cpu"))


def test_library_hash_tracks_sources():
    """The build cache key covers every CUDA source and the flags."""
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libmmnm_kernels_")
    assert {p.name for p in _build.SRC_DIR.glob("*.cu")} == {
        "encoder.cu", "pred_deviation.cu", "decoder_nll.cu", "train_step.cu",
        "train_step_bf16.cu", "masked_adam.cu"}
    assert {p.name for p in _build.SRC_DIR.glob("*.cuh")} == {
        "tile_product.cuh", "train_step.cuh"}
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
