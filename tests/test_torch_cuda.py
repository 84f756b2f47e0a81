"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: they skip on a machine without a CUDA device. On the GPU
machine, from the repository root:

    python -m pytest -m cuda tests/test_torch_cuda.py

TF32 is off, so the plain versions run true fp32 like the kernels;
tolerance rtol/atol 1e-5 for mu, logvar and recon (sums in another order),
rtol 1e-4 for the per-row deviation (a 3485-term reduction).
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
