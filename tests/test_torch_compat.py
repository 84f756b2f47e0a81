"""The port's imperative facade (compat/), on the CPU (``device="cpu"``).

The cases of tests/test_imperative_compat.py, against the JAX facade (the
repository root's cVAE.py): the reference hot loop verbatim with torch
DataLoaders; one step from the JAX facade's parameters and noise draw
equal to the JAX facade's step, loss and every parameter after Adam, at
rtol 1e-5 / atol 1e-6, for the six registry classes, the end-to-end
(without dropout, whose masks the two packages draw differently) and the
regression protocol; the Q1 dead ``optimizer1.lr``; a component's backward
and its accumulation; DataFrame inputs of ``pred_recon``; ``torch.save`` /
``torch.load`` with the generator's state; the module-level ops against
the JAX facade's; the constructors' defaults; the excluded legacy
symbols. Where torch itself differs from the JAX facade: a loss's backward
after ``optimizer1.step()`` raises torch's in-place error (the JAX facade
differentiates at the loss-time parameters).
"""
import io
import sys
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import cVAE as jax_facade  # noqa: E402  (the JAX facade's shim)

from multi_modal_normative_modeling_tpu.cli.common import (  # noqa: E402
    host_prng_key,
)
from multi_modal_normative_modeling_tpu_torch import compat  # noqa: E402
from multi_modal_normative_modeling_tpu_torch.interop import (  # noqa: E402
    params_from_jax,
    params_to_jax,
)
from tests.test_torch_threads import one_torch_thread  # noqa: E402,F401

DIMS = [12, 9]
HIDDEN = [16, 16]
LATENT = 6
C_DIM = 4
N = 32
CPU = "cpu"
STEP_TOL = dict(rtol=1e-5, atol=1e-6)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    xes = [rng.normal(size=(N, d)).astype(np.float32) for d in DIMS]
    cs = [rng.normal(size=(N, C_DIM)).astype(np.float32) for _ in DIMS]
    return xes, cs


def _kwargs(**extra):
    return dict(input_dim_list=DIMS, hidden_dim=HIDDEN, latent_dim=LATENT,
                c_dim=C_DIM, learning_rate=0.0001, modalities=len(DIMS),
                non_linear=True, **extra)


def _pair(name, **extra):
    """(the JAX facade, the port's holding its parameters)."""
    jax_model = getattr(jax_facade, name)(**_kwargs(**extra))
    port = getattr(compat, name)(device=CPU, **_kwargs(**extra))
    params_from_jax(jax.tree_util.tree_map(np.asarray, jax_model._params),
                    port.core)
    return jax_model, port


def _replay_draw(port, sub, rows=N):
    """The port's facade draws what the JAX facade drew from ``sub``."""
    def draw(shape):
        eps = jax.random.normal(sub, (rows, port.core.noise_dim))
        return torch.from_numpy(np.asarray(eps)).reshape(shape)
    port._draw = draw


def _first_subkey():
    """The subkey the JAX facade's first forward splits off seed 42."""
    return jax.random.split(host_prng_key(42))[1]


def _close_params(jax_model, port, loose=()):
    """Every parameter after the step at STEP_TOL; the paths containing a
    ``loose`` key within two learning rates (a bias right before BatchNorm
    has a zero gradient up to rounding, which Adam's first step turns into
    a step of about lr in either direction)."""
    got = params_to_jax(port.core, fold=0)
    want = jax.tree_util.tree_map(np.asarray,
                                  jax.device_get(jax_model._params))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert set(flat_got) <= set(flat_want)
    for path, leaf in flat_got.items():
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        tol = (dict(rtol=0.0, atol=2e-4)
               if any(k in keys for k in loose) and keys[-1] == "b"
               else STEP_TOL)
        np.testing.assert_allclose(leaf, flat_want[path], err_msg=str(path),
                                   **tol)


def _step(model, xes, cs, combine):
    fwd = model.forward_multimodal(xes, cs, combine)
    loss = model.loss_function_multimodal(xes, fwd)
    model.optimizer1.zero_grad()
    loss["total"].backward()
    model.optimizer1.step()
    return loss


def test_reference_hot_loop_verbatim_with_torch_dataloaders():
    from torch.utils.data import DataLoader

    import utils_vae

    xes, cs = _batch()
    loaders = [DataLoader(utils_vae.MyDataset_labels(x, c), batch_size=16,
                          shuffle=False) for x, c in zip(xes, cs)]
    model = compat.cVAE_multimodal(device=CPU, **_kwargs()).to(CPU)
    epoch_first_batch = []
    for epoch in range(10):
        for batch_idx, batch in enumerate(zip(*loaders)):
            x_list = [b[0].to(CPU) for b in batch]
            c_list = [b[1].to(CPU) for b in batch]
            fwd = model.forward_multimodal(x_list, c_list, "gPoE")
            loss = model.loss_function_multimodal(x_list, fwd)
            model.optimizer1.lr = 0.5  # reference Q1: dead attribute write
            model.optimizer1.zero_grad()
            loss["total"].backward()
            model.optimizer1.step()
            assert np.isfinite(round(loss["total"].item(), 3))
            if batch_idx == 0:
                epoch_first_batch.append(loss["total"].item())
    assert epoch_first_batch[-1] < epoch_first_batch[0]
    assert isinstance(fwd["mu_multimodal"], torch.Tensor)
    assert fwd["recon_means"][0].cpu().detach().numpy().shape == (16, DIMS[0])
    assert all(isinstance(p, torch.nn.Parameter) for p in model.parameters())


@pytest.mark.parametrize("name", ["cVAE_multimodal", "mmJSD", "DMVAE",
                                  "WeightedDMVAE", "mvtCAE", "mmVAEPlus"])
def test_one_step_matches_the_jax_facade(name):
    xes, cs = _batch()
    jax_model, port = _pair(name)
    _replay_draw(port, _first_subkey())
    combine = "gPoE" if name == "cVAE_multimodal" else "PoE"
    want = _step(jax_model, xes, cs, combine)
    got = _step(port, xes, cs, combine)
    for k in want:
        np.testing.assert_allclose(got[k].item(), want[k].item(), err_msg=k,
                                   **STEP_TOL)
    _close_params(jax_model, port)
    # Q1: the lr=1e-4 step moved the parameters by about lr
    port.optimizer1.lr = 999.0
    assert port.optimizer1.param_groups[0]["lr"] == 0.0001


def test_component_backward_and_accumulation():
    xes, cs = _batch()
    jax_model, port = _pair("cVAE_multimodal")
    _replay_draw(port, _first_subkey())
    fwd = port.forward_multimodal(xes, cs, "PoE")
    loss = port.loss_function_multimodal(xes, fwd)
    port.optimizer1.zero_grad()
    loss["kl"].backward()
    g1 = [p.grad.clone() for p in port.parameters() if p.grad is not None]
    loss["kl"].backward()
    g2 = [p.grad for p in port.parameters() if p.grad is not None]
    assert g1 and len(g1) == len(g2)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(2 * a, b)
    # the kl gradient against the JAX facade's
    jfwd = jax_model.forward_multimodal(xes, cs, "PoE")
    jloss = jax_model.loss_function_multimodal(xes, jfwd)
    jax_model.optimizer1.zero_grad()
    jloss["kl"].backward()
    want = jax.device_get(jax_model._grads)
    enc = port.core.enc[0].mu
    np.testing.assert_allclose(enc.weight.grad[0].numpy().T / 2,
                               np.asarray(want["enc"][0]["mu"]["w"]),
                               **STEP_TOL)


def test_pred_recon_and_deviation_dataframe_inputs():
    xes, cs = _batch()
    model = compat.cVAE_multimodal(device=CPU, **_kwargs())
    frames = [pd.DataFrame(x) for x in xes]
    r1 = model.pred_recon(frames, cs[0], compat.DEVICE, "gPoE")
    r2 = model.pred_recon(frames, cs[0], compat.DEVICE, "gPoE")
    assert [r.shape for r in r1] == [(N, d) for d in DIMS]
    assert not np.allclose(r1[0], r2[0])  # a fresh draw each call (Q2)
    dev = model.reconstruction_deviation_multimodal(frames, r1)
    assert len(dev) == len(DIMS) and dev[0].shape == (N,)
    np.testing.assert_allclose(dev[0],
                               np.sum((xes[0] - r1[0]) ** 2, axis=1) / DIMS[0],
                               rtol=1e-6)


def test_torch_save_load_roundtrip():
    xes, cs = _batch()
    model = compat.cVAE_multimodal(device=CPU, **_kwargs())
    _step(model, xes, cs, "gPoE")
    buf = io.BytesIO()
    torch.save(model, buf)
    buf.seek(0)
    restored = torch.load(buf, weights_only=False)
    for a, b in zip(model.state_dict().values(),
                    restored.state_dict().values()):
        assert torch.equal(a, b)
    assert torch.equal(model._gen.get_state(), restored._gen.get_state())
    same = [np.array_equal(a, b) for a, b in zip(
        model.pred_recon(xes, cs[0]), restored.pred_recon(xes, cs[0]))]
    assert all(same)
    # the restored model keeps training: Adam's state came along
    assert restored.optimizer1.state
    loss = _step(restored, xes, cs, "gPoE")
    assert np.isfinite(loss["total"].item())


def test_endtoend_protocol_and_one_step():
    xes, cs = _batch()
    labels = np.array([0, 1] * (N // 2), dtype=np.int64)
    extra = dict(classifier_layers=[8, 4], dropout_rate=0.0, num_classes=2)
    jax_model, port = _pair("cVAE_multimodal_endtoend", **extra)
    sub = _first_subkey()
    _, z_key, _ = jax.random.split(sub, 3)
    _replay_draw(port, z_key)
    losses = []
    for model in (jax_model, port):
        fwd = model.forward(xes, cs)
        loss = model.loss_function(xes, fwd, torch.from_numpy(labels), 1.0,
                                   0.1)
        model.optimizer.zero_grad()
        loss["total_loss"].backward()
        model.optimizer.step()
        losses.append(loss)
    for k in losses[0]:
        np.testing.assert_allclose(losses[1][k].item(), losses[0][k].item(),
                                   err_msg=k, **STEP_TOL)
    _close_params(jax_model, port, loose=("blocks",))
    # the reference loop (nmpmcont:296-315) with dropout, then predict
    model = compat.cVAE_multimodal_endtoend(
        device=CPU, **_kwargs(classifier_layers=[8, 4], dropout_rate=0.5,
                              num_classes=2))
    model.optimizer.lr = 0.5  # nmpmcont:283, the same dead write
    first = last = None
    for _ in range(10):
        fwd = model.forward(xes, cs)
        loss = model.loss_function(xes, fwd, torch.from_numpy(labels), 1.0,
                                   0.1)
        model.optimizer.zero_grad()
        loss["total_loss"].backward()
        model.optimizer.step()
        first = loss["total_loss"].item() if first is None else first
        last = loss["total_loss"].item()
    assert last < first
    model.eval()
    assert torch.argmax(model.predict(xes, cs), dim=1).shape == (N,)


def test_regression_protocol_and_one_step():
    xes, cs = _batch()
    c2 = [c[:, :2] for c in cs]
    fi = np.random.default_rng(1).normal(30, 5, size=(N, 1)).astype(
        np.float32)
    kwargs = {**_kwargs(), "c_dim": 2}
    jax_model = jax_facade.cVAE_multimodal_regression(**kwargs)
    port = compat.cVAE_multimodal_regression(device=CPU, **kwargs)
    params_from_jax(jax.tree_util.tree_map(np.asarray, jax_model._params),
                    port.core)
    _replay_draw(port, _first_subkey())
    losses = []
    for model in (jax_model, port):
        fwd = model.forward_multimodal(xes, c2, "gpoe")
        loss = model.loss_function_multimodal(xes, fwd, fi, lambda_reg=1.0)
        model.optimizer1.zero_grad()
        loss["total"].backward()
        model.optimizer1.step()
        losses.append(loss)
    for k in losses[0]:
        np.testing.assert_allclose(losses[1][k].item(), losses[0][k].item(),
                                   err_msg=k, **STEP_TOL)
    _close_params(jax_model, port)
    assert fwd["fi_pred"].cpu().detach().numpy().shape == (N, 1)
    x_t, c_t = torch.from_numpy(xes[0]), torch.from_numpy(c2[0])
    mu, logvar = port.encode(x_t, c_t, 0)
    dist = port.decode(port.reparameterise(mu, logvar), c_t, 0)
    deviation = ((x_t - dist.loc) ** 2).cpu().detach().numpy()
    assert deviation.shape == (N, DIMS[0]) and np.isfinite(deviation).all()


def test_module_level_ops_match_the_jax_facade():
    rng = np.random.default_rng(3)
    mus = rng.normal(size=(3, 8, LATENT)).astype(np.float32)
    var = np.exp(rng.normal(size=(3, 8, LATENT))).astype(np.float32)
    for name in ("ProductOfExperts", "ProductOfExperts2", "MixtureOfExperts",
                 "MoPoE"):
        got = getattr(compat, name)()(mus, var)
        want = getattr(jax_facade, name)()(mus, var)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       err_msg=name)
    x = torch.from_numpy(rng.normal(size=(8, 5)).astype(np.float32))
    dist = compat.Normal(torch.zeros(8, 5), torch.ones(8, 5))
    np.testing.assert_allclose(
        compat.compute_ll(x, dist).numpy(),
        jax_facade.compute_ll(x, jax_facade.Normal(torch.zeros(8, 5),
                                                   torch.ones(8, 5))).numpy(),
        rtol=1e-6)
    logits = rng.normal(size=(16,)).astype(np.float32)
    for targets in (np.arange(16) % 2, 1 - np.arange(16) % 2):
        for reduce in (True, False):
            np.testing.assert_allclose(
                compat.FocalLoss(reduce=reduce)(logits, targets).numpy(),
                jax_facade.FocalLoss(reduce=reduce)(logits, targets).numpy(),
                rtol=1e-5, atol=1e-7)


def test_ctor_defaults_match_reference():
    m = compat.cVAE_multimodal(input_dim_list=[5, 5, 5], hidden_dim=[8, 8],
                               latent_dim=3, c_dim=2, device=CPU)
    assert m.core.modalities == 3 and m.core.non_linear is False
    assert compat.DEVICE == "cuda"


def test_the_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device is available"):
        compat.cVAE_multimodal(**_kwargs())


def test_eval_mode_loss_backward_works():
    xes, cs = _batch()
    model = compat.cVAE_multimodal(device=CPU, **_kwargs())
    model.eval()
    fwd = model.forward_multimodal(xes, cs, "PoE")
    loss = model.loss_function_multimodal(xes, fwd)
    loss["total"].backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert grads and all(torch.isfinite(g).all() for g in grads)


def test_backward_after_the_step_raises_as_torch_does():
    """The JAX facade differentiates at the loss-time parameters; on
    torch's autograd the step changed them in place, and torch raises."""
    xes, cs = _batch()
    model = compat.cVAE_multimodal(device=CPU, **_kwargs())
    fwd = model.forward_multimodal(xes, cs, "PoE")
    loss = model.loss_function_multimodal(xes, fwd)
    model.optimizer1.zero_grad()
    loss["total"].backward()
    model.optimizer1.step()
    model.optimizer1.zero_grad()
    with pytest.raises(RuntimeError, match="inplace operation"):
        loss["kl"].backward()


@pytest.mark.parametrize("name", ["mmcVAE", "cVAE",
                                  "cVAE_multimodal_before_refactor",
                                  "MVTCAE", "ResidualBlock"])
def test_excluded_legacy_symbols_raise_loud_message(name):
    with pytest.raises(ImportError, match="excluded legacy symbol") as exc:
        getattr(compat, name)
    with pytest.raises(ImportError) as jax_exc:
        getattr(jax_facade, name)
    assert str(exc.value) == str(jax_exc.value)
    assert compat._EXCLUDED_LEGACY == jax_facade._EXCLUDED_LEGACY
    with pytest.raises(AttributeError):
        compat.no_such_symbol_xyz
