"""kernels/roofline.py against counts worked out by hand at the flagship and
PPMI shapes, and against the products that the plain versions really do
(torch's FLOP counter over models/stacked.py's forward and its autograd
backward, and over the per-modality encoder and decoder)."""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from multi_modal_normative_modeling_tpu_torch.interop import packed_from_model
from multi_modal_normative_modeling_tpu_torch.kernels import roofline
from multi_modal_normative_modeling_tpu_torch.kernels.train_step import (
    FusedTrainStep,
)
from multi_modal_normative_modeling_tpu_torch.models import (
    Decoder,
    Encoder,
    build_model,
)
from multi_modal_normative_modeling_tpu_torch.models.stacked import (
    StackedMultimodalCVAE,
)

FLAGSHIP = dict(dims=[90, 90, 90, 270], c=29, hidden=[110, 110], z=10)
PPMI = dict(dims=[3485] * 3, c=2, hidden=[110, 110], z=10)


def test_flagship_forward_mac_by_hand():
    # per row, 90-wide modality: (90+29)*110 + 110*110 + 2*110*10 encoder,
    # (10+29)*110 + 110*110 + 110*90 decoder = 53,680; 270-wide: 93,280
    assert roofline.encoder_mac(90, 29, [110, 110], 10)[0] == 27390
    assert roofline.decoder_mac(90, 29, [110, 110], 10)[0] == 26290
    fwd, bwd, params = roofline.train_step_mac(**FLAGSHIP)
    assert fwd == 3 * 53680 + 93280 == 254320
    # backward: twice the forward, less dx and dc of the two first layers
    assert bwd == 2 * 254320 - (3 * (119 + 29) * 110 + (299 + 29) * 110)
    # parameters: each product's weights and bias, lvo, alpha
    assert params == 3 * (53680 + 110 * 4 + 20 + 90 * 2) + (
        93280 + 110 * 4 + 20 + 270 * 2) + 4


def test_ppmi_forward_mac_by_hand():
    fwd, _, _ = roofline.train_step_mac(**PPMI)
    assert fwd == 3 * ((3485 + 2) * 110 + 110 * 110 + 2 * 110 * 10
                       + (10 + 2) * 110 + 110 * 110 + 110 * 3485) == 2383920


def test_train_step_bounds_by_hand():
    w = roofline.fused_train_step(5, 256, **FLAGSHIP)
    assert w.flop == 2.0 * 1280 * (254320 + 423720)
    assert w.bound_by == "operations" and "fp32" in w.peak_name
    assert w.bound_ms == pytest.approx(w.flop / 67e12 * 1e3)
    assert w.bound_ms == pytest.approx(0.02591, rel=1e-3)
    # bf16: the same products at the tensor cores' rate; the bytes bound
    b = roofline.fused_train_step(5, 256, **FLAGSHIP, bf16=True)
    assert b.flop == w.flop and b.bound_by == "bytes"
    assert b.bytes < w.bytes and "bf16" in b.peak_name
    assert b.bound_ms == pytest.approx(b.bytes / 3.35e12 * 1e3)
    p = roofline.fused_train_step(1, 256, **PPMI)
    assert p.bound_by == "operations"
    assert p.bound_ms == pytest.approx(
        2.0 * 256 * (3 * 2383920 - 3 * (3487 + 2) * 110) / 67e12 * 1e3)


def test_bytes_by_hand():
    # K1 at F=5 B=1024 D=270: x, c, the parameters, mu and logvar, fp32
    w = roofline.fused_encoder(5, 1024, 270, 29, [110, 110], 10)
    params = 299 * 110 + 110 + 110 * 110 + 110 + 2 * (110 * 10 + 10)
    assert w.bytes == 4 * (5120 * 299 + 5 * params + 2 * 5120 * 10)
    assert w.flop == 2 * 5120 * (299 * 110 + 110 * 110 + 2 * 1100)
    # K2 reads x and writes the reconstruction and one deviation per row
    k3 = roofline.fused_decoder_mean(5, 1024, 270, 29, [110, 110], 10)
    k2 = roofline.fused_pred_deviation(5, 1024, 270, 29, [110, 110], 10)
    assert k2.flop == k3.flop
    assert k2.bytes - k3.bytes == 4 * (5120 * 270 + 5120)
    # K4 forward + backward: three products of B x H x D
    k4 = roofline.decoder_nll(5, 256, 110, 270)
    assert k4.flop == 3 * 2 * 1280 * 110 * 270
    assert roofline.decoder_nll(5, 256, 110, 270, backward=False).flop * 3 \
        == k4.flop
    assert (k4 + k4).flop == 2 * k4.flop


def _normal(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))


@pytest.mark.parametrize("dims,hidden,c,z", [
    ([12, 12, 12], [16, 8], 5, 4), ([20], [8], 3, 2),
    ([9, 9], [8, 12, 6], 4, 3)])
def test_train_step_flop_matches_the_plain_version(dims, hidden, c, z):
    """Equal widths, so the packed model pads nothing: the forward's
    products are the module's forward MAC, and forward + autograd backward
    its whole step plus one product that the step does not need: autograd
    takes the gradient of the whole [z | c] input of the first decoder layer,
    its c columns too, because the z columns need one."""
    folds, rows = 2, 6
    rng = np.random.default_rng(0)
    model = build_model("cVAE_multimodal", dims, hidden, z, c, len(dims),
                        folds=folds, generator=torch.Generator().manual_seed(0))
    stacked = StackedMultimodalCVAE(dims, hidden, z, c, len(dims))
    packed = packed_from_model(model, stacked)
    x = stacked.pack_inputs([_normal(rng, folds, rows, d) for d in dims])
    cov, eps = _normal(rng, folds, rows, c), _normal(rng, folds, rows, z)
    fwd, bwd, _ = roofline.train_step_mac(dims, c, hidden, z)
    with FlopCounterMode(display=False) as counter:
        stacked.forward(packed, x, cov, "gpoe", eps)
    assert counter.get_total_flops() == 2 * folds * rows * fwd
    step = FusedTrainStep(stacked, "gpoe")
    named = step.pad_params(packed)
    batch = step.pack_batch(x, cov, torch.ones(folds, rows))
    with FlopCounterMode(display=False) as counter:
        step.reference(named, batch[0], batch[1], eps, *batch[2:])
    want = roofline.fused_train_step(folds, rows, dims, c, hidden, z).flop
    assert want == 2 * folds * rows * (fwd + bwd)
    unneeded = 2 * folds * rows * len(dims) * c * hidden[-1]
    assert counter.get_total_flops() == want + unneeded


def test_encoder_decoder_flop_match_the_plain_versions():
    folds, rows, d, c, z, hidden = 2, 5, 14, 3, 4, [8, 6]
    rng = np.random.default_rng(1)
    gen = torch.Generator().manual_seed(1)
    enc = Encoder(d, hidden, z, c, folds=folds, generator=gen)
    dec = Decoder(d, hidden, z, c, folds=folds, generator=gen)
    x, cov = _normal(rng, folds, rows, d), _normal(rng, folds, rows, c)
    lat = _normal(rng, folds, rows, z)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        enc(x, cov)
    assert counter.get_total_flops() == roofline.fused_encoder(
        folds, rows, d, c, hidden, z).flop
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        dec(lat, cov)
    assert counter.get_total_flops() == roofline.fused_decoder_mean(
        folds, rows, d, c, hidden, z).flop
