"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: they skip on a machine without a CUDA device. On the GPU
machine, from the repository root:

    python -m pytest -m cuda tests/test_torch_cuda.py

TF32 is off, so the plain versions run true fp32 like the kernels;
tolerance rtol/atol 1e-5 for mu, logvar and recon (sums in another order),
rtol 1e-4 for the per-row deviation (a 3485-term reduction). decoder_nll is
held to tests/test_decoder_nll.py's bounds: the value rtol 1e-5, gradients
rtol 1e-4 / atol 1e-6 (rtol 1e-3 / atol 1e-5 at D = 3485), trajectories
rtol 1e-4 (logs) and rtol 5e-3 / atol 1e-5 (parameters).
"""
import numpy as np
import pytest
import torch

from multi_modal_normative_modeling_tpu_torch import kernels
from multi_modal_normative_modeling_tpu_torch.models import (
    Decoder,
    Encoder,
    build_model,
)

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-5, atol=1e-5)
CASES = [(1, 7, 90, 29, [110, 110]), (5, 1024, 270, 29, [110, 110]),
         (1, 1024, 3485, 2, [110, 110]), (2, 33, 90, 29, [460, 460]),
         (3, 65, 45, 3, []), (1, 40, 130, 29, [64, 110, 32])]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m cuda "
                    "tests/test_torch_cuda.py` on the GPU machine")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rows(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))


@pytest.mark.parametrize("non_linear", [True, False])
@pytest.mark.parametrize("folds,rows,d,c_dim,hidden", CASES)
def test_encoder_kernel_matches_plain(cuda, folds, rows, d, c_dim, hidden,
                                      non_linear):
    rng = np.random.default_rng(rows + d)
    enc = Encoder(d, hidden, 10, c_dim, non_linear, folds,
                  torch.Generator().manual_seed(0), cuda)
    x, c = _rows(rng, folds, rows, d).to(cuda), _rows(
        rng, folds, rows, c_dim).to(cuda)
    with torch.no_grad():
        before = kernels.fused_encoder.launches
        mu, lv = enc.fused(x, c)
        assert kernels.fused_encoder.launches == before + 1
        mu_p, lv_p = enc(x, c)
    torch.testing.assert_close(mu, mu_p, **TOL)
    torch.testing.assert_close(lv, lv_p, **TOL)


@pytest.mark.parametrize("non_linear", [True, False])
@pytest.mark.parametrize("folds,rows,d,c_dim,hidden", CASES)
def test_pred_deviation_kernel_matches_plain(cuda, folds, rows, d, c_dim,
                                             hidden, non_linear):
    rng = np.random.default_rng(rows * d)
    dec = Decoder(d, hidden, 10, c_dim, non_linear, folds,
                  generator=torch.Generator().manual_seed(1), device=cuda)
    z, c, x = (_rows(rng, folds, rows, 10).to(cuda),
               _rows(rng, folds, rows, c_dim).to(cuda),
               _rows(rng, folds, rows, d).to(cuda))
    with torch.no_grad():
        recon, dev = dec.fused_pred_deviation(z, c, x)
        recon_p = dec(z, c)[0]
    torch.testing.assert_close(recon, recon_p, **TOL)
    torch.testing.assert_close(
        dev, kernels.reconstruction_deviation(x, recon_p), rtol=1e-4,
        atol=1e-6)


def test_scoring_call_runs_every_modality_through_the_kernels(cuda):
    dims = [90, 90, 90, 270]
    model = build_model("cVAE_multimodal", dims, [110, 110], 10, 29, 4,
                        folds=5, generator=torch.Generator().manual_seed(0),
                        device=cuda)
    rng = np.random.default_rng(0)
    xes = [_rows(rng, 5, 256, d).to(cuda) for d in dims]
    cs = [_rows(rng, 5, 256, 29).to(cuda)] * 4
    eps = _rows(rng, 5, 256, 10).to(cuda)
    kernels.reset_launch_counts()
    recons, devs = model.pred_recon_fused(xes, cs, "gpoe", eps=eps)
    assert kernels.fused_encoder.launches == 4
    assert kernels.fused_pred_deviation.launches == 4
    with torch.no_grad():
        ref = model.pred_recon(xes, cs, "gpoe", eps=eps)
    for m in range(4):
        torch.testing.assert_close(recons[m], ref[m], rtol=2e-4, atol=2e-5)
        torch.testing.assert_close(
            devs[m], model.reconstruction_deviation(xes[m], ref[m]),
            rtol=2e-4, atol=2e-5)


def test_kernel_refuses_what_it_does_not_take(cuda):
    enc = Encoder(90, [110], 10, 29, device=cuda)
    x = torch.zeros(1, 8, 90, device=cuda)
    c = torch.zeros(1, 8, 29, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        enc.fused(torch.zeros(1, 90, 8, device=cuda).mT, c)
    with pytest.raises(ValueError, match="float32"):
        enc.fused(x.double(), c)
    with pytest.raises(ValueError, match="expected"):
        enc.fused(torch.zeros(1, 8, 91, device=cuda), c)


# ---- decoder_nll (forward and backward) -------------------------------------

def _nll_operands(cuda, rng, folds, rows, hidden, d):
    def normal(*shape, scale=1.0):
        return (_rows(rng, *shape) * scale).to(cuda)

    # as chip_smoke.check_nll: gradient entries of order 1, x drawn from
    # the decoder's own Gaussian
    g = normal(folds, rows, hidden, scale=0.5).requires_grad_()
    w = normal(folds, d, hidden, scale=0.05).requires_grad_()
    b = normal(folds, d, scale=0.1).requires_grad_()
    lvo = (normal(folds, 1, d, scale=0.1) - 1.0).requires_grad_()
    with torch.no_grad():
        x = (g @ w.mT + b[:, None] + torch.exp(0.5 * lvo)
             * normal(folds, rows, d))
    mask = torch.ones(folds, rows, device=cuda)
    for f in range(folds):
        mask[f, max(rows - 2 - f, 0):] = 0.0
    return (g, w, b, lvo), x, mask, torch.clamp(mask.sum(-1), min=1.0)


@pytest.mark.parametrize("folds,rows,hidden,d", [
    (1, 7, 110, 90), (5, 256, 110, 270), (1, 256, 110, 3485),
    (3, 65, 17, 130), (2, 1, 110, 64), (2, 300, 529, 90)])
def test_decoder_nll_kernels_match_autograd(cuda, folds, rows, hidden, d):
    from multi_modal_normative_modeling_tpu_torch.kernels.decoder_nll import (
        decoder_nll,
        decoder_nll_reference,
    )

    rng = np.random.default_rng(d + rows)
    params, x, mask, n = _nll_operands(cuda, rng, folds, rows, hidden, d)

    def run(fn):
        ll = fn(*params, x, mask, n)
        return ll, torch.autograd.grad(ll.sum(), params)

    before = kernels.decoder_nll.launches
    ll, grads = run(decoder_nll)
    assert kernels.decoder_nll.launches == before + 2
    ll_p, grads_p = run(decoder_nll_reference)
    torch.testing.assert_close(ll, ll_p, rtol=1e-5, atol=0.0)
    tol = (dict(rtol=1e-3, atol=1e-5) if d > 270
           else dict(rtol=1e-4, atol=1e-6))
    for got, want in zip(grads, grads_p):
        torch.testing.assert_close(got, want, **tol)
    for a, b in zip(grads, run(decoder_nll)[1]):
        assert torch.equal(a, b)


def test_decoder_nll_refuses_what_it_does_not_take(cuda):
    from multi_modal_normative_modeling_tpu_torch.kernels.decoder_nll import (
        decoder_nll,
    )

    rng = np.random.default_rng(0)
    (g, w, b, lvo), x, mask, n = _nll_operands(cuda, rng, 2, 8, 16, 40)
    with pytest.raises(ValueError, match="contiguous"):
        decoder_nll(g.detach().mT.contiguous().mT, w, b, lvo, x, mask, n)
    with pytest.raises(ValueError, match="expected"):
        decoder_nll(g, w, b, lvo, x[:, :, :39].contiguous(), mask, n)
    wide = _nll_operands(cuda, rng, 1, 8, 530, 40)
    with pytest.raises(ValueError, match="shared memory"):
        decoder_nll(*wide[0], *wide[1:])


def test_fused_decoder_training_matches_plain(cuda):
    """A few steps of the flagship model with the --fused_decoder loss stay
    within the trajectory bound of the plain loss (same init, same eps)."""
    from multi_modal_normative_modeling_tpu_torch.kernels.decoder_nll import (
        fused_decoder_loss_fn,
    )
    from multi_modal_normative_modeling_tpu_torch.parallel import (
        MultiFoldTrainer,
        stack_fold_batches,
    )
    from multi_modal_normative_modeling_tpu_torch.train import TrainConfig

    dims = [90, 270]
    rng = np.random.default_rng(3)
    sizes = [300, 260]
    data = [[rng.standard_normal((s, d), dtype=np.float32) for d in dims]
            for s in sizes]
    cov = [[rng.standard_normal((s, 29), dtype=np.float32)] * 2
           for s in sizes]
    batches = stack_fold_batches(data, cov, 256)
    eps = torch.randn(6, 2, 256, 10, generator=torch.Generator().manual_seed(0))
    config = TrainConfig(epochs=3, batch_size=256)
    out = []
    for fused in (False, True):
        model = build_model("cVAE_multimodal", dims, [110, 110], 10, 29, 2,
                            folds=2, generator=torch.Generator().manual_seed(1),
                            device=cuda)
        loss = fused_decoder_loss_fn(model, config) if fused else None
        logs = MultiFoldTrainer(model, config, 300, loss_fn=loss).run(
            batches, eps=eps)
        out.append((logs, model.state_dict()))
    (logs_p, state_p), (logs_k, state_k) = out
    for k in logs_p:
        np.testing.assert_allclose(logs_k[k], logs_p[k], rtol=1e-4)
    for k in state_p:
        torch.testing.assert_close(state_k[k], state_p[k], rtol=5e-3,
                                   atol=1e-5)
