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
# at 3485 the decode kernel splits the mean head's columns over blocks (7
# groups), with 1000 rows over a ragged last row tile; the others take one
# group
CASES = [(1, 7, 90, 29, [110, 110]), (5, 1024, 270, 29, [110, 110]),
         (1, 1024, 3485, 2, [110, 110]), (1, 1000, 3485, 2, [110, 110]),
         (2, 33, 90, 29, [460, 460]), (3, 65, 45, 3, []),
         (1, 40, 130, 29, [64, 110, 32]), (2, 100, 271, 2, [57, 33])]


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
    from multi_modal_normative_modeling_tpu_torch.kernels import deviation

    with torch.no_grad():
        before = kernels.fused_pred_deviation.launches
        recon, dev = dec.fused_pred_deviation(z, c, x)
        assert kernels.fused_pred_deviation.launches == before + 1
        recon_p = dec(z, c)[0]
        again = dec.fused_pred_deviation(z, c, x)
    torch.testing.assert_close(recon, recon_p, **TOL)
    torch.testing.assert_close(
        dev, kernels.reconstruction_deviation(x, recon_p), rtol=1e-4,
        atol=1e-6)
    # partial deviations are summed in group order: bit-equal repeats
    assert torch.equal(dev, again[1]) and torch.equal(recon, again[0])
    plan = deviation.plan(folds, rows, 10 + c_dim, tuple(hidden), d)
    if d == 3485:
        assert plan.groups == 7   # the column-group route


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


# (5, 256, 110, 3485) splits the forward's columns 6 ways and the
# backward's rows 8 ways; (2, 300, 529, 90) has 5 h blocks and one column
# chunk; (2, 40, 130, 1000) two h blocks and 8 chunks
@pytest.mark.parametrize("uniform", [True, False],
                         ids=["uniform", "nonuniform"])
@pytest.mark.parametrize("folds,rows,hidden,d", [
    (1, 7, 110, 90), (5, 256, 110, 270), (1, 256, 110, 3485),
    (3, 65, 17, 130), (2, 1, 110, 64), (2, 300, 529, 90),
    (5, 256, 110, 3485), (2, 40, 130, 1000)])
def test_decoder_nll_kernels_match_autograd(cuda, folds, rows, hidden, d,
                                            uniform):
    import importlib

    nll = importlib.import_module(
        "multi_modal_normative_modeling_tpu_torch.kernels.decoder_nll")
    decoder_nll, decoder_nll_reference = (nll.decoder_nll,
                                          nll.decoder_nll_reference)
    plan = nll.plan(folds, rows, hidden, d)
    if (folds, d) == (5, 3485):
        assert (plan.fwd_split, plan.bwd_split) == (6, 8)

    rng = np.random.default_rng(d + rows)
    params, x, mask, n = _nll_operands(cuda, rng, folds, rows, hidden, d)
    # the cotangent of ll: all ones, or distinct per fold with the last 0
    a = (torch.ones(folds, device=cuda) if uniform or folds == 1
         else torch.linspace(1.5, 0.0, folds, device=cuda))
    if folds == 1 and not uniform:
        a = a * 0.75

    def run(fn, cast=lambda t: t):
        leaves = [cast(p.detach()).requires_grad_() for p in params]
        ll = fn(*leaves, cast(x), cast(mask), cast(n))
        grads = torch.autograd.grad((cast(a) * ll).sum(), leaves)
        return ll.detach().float(), [t.float() for t in grads]

    before = kernels.decoder_nll.launches
    ll, grads = run(decoder_nll)
    assert kernels.decoder_nll.launches == before + 2
    # the plain code in fp64: on the card its fp32 sums (cuBLAS) stray
    # further from fp64 than the kernel's
    ll_p, grads_p = run(decoder_nll_reference, lambda t: t.double())
    torch.testing.assert_close(ll, ll_p, rtol=1e-5, atol=0.0)
    tol = (dict(rtol=1e-3, atol=1e-5) if d > 270
           else dict(rtol=1e-4, atol=1e-6))
    for got, want in zip(grads, grads_p):
        torch.testing.assert_close(got, want, **tol)
    for got, rep in zip(grads, run(decoder_nll)[1]):
        assert torch.equal(got, rep)
    if not uniform and folds > 1:
        # a zero cotangent reaches every gradient of its fold, and only it
        assert all(float(t[-1].abs().max()) == 0.0 for t in grads)
        if rows > 2:
            assert all(float(t[0].abs().max()) > 0.0 for t in grads)


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
    wide = _nll_operands(cuda, rng, 1, 8, 1800, 40)
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


# ---- fused_decoder_mean (K3) --------------------------------------------------

@pytest.mark.parametrize("non_linear", [True, False])
@pytest.mark.parametrize("folds,rows,d,c_dim,hidden", CASES)
def test_decoder_mean_kernel_matches_plain(cuda, folds, rows, d, c_dim,
                                           hidden, non_linear):
    rng = np.random.default_rng(rows + 2 * d)
    dec = Decoder(d, hidden, 10, c_dim, non_linear, folds,
                  generator=torch.Generator().manual_seed(2), device=cuda)
    z, c = (_rows(rng, folds, rows, 10).to(cuda),
            _rows(rng, folds, rows, c_dim).to(cuda))
    with torch.no_grad():
        before = kernels.fused_decoder_mean.launches
        mean = dec.fused_mean(z, c)
        assert kernels.fused_decoder_mean.launches == before + 1
        torch.testing.assert_close(mean, dec(z, c)[0], **TOL)


# ---- the fused train step (K5) and its batch-tiled form (K6) -----------------
# The kernels are held to the plain version evaluated in fp64 (the plain
# code on double operands): cuBLAS's fp32 sums at the flagship strayed
# further from it than the kernel does (chip_smoke.plain64). Bounds are the
# JAX tests': losses rtol 1e-5, gradients rtol 1e-3 / atol 1e-5 (rtol 2e-3
# / atol 2e-5 at 3485), K6 fp32 against K5 rtol 1e-4 / atol 1e-6, bf16
# within a normalized 6e-2 of fp32 per gradient leaf and 5e-3 of its own
# plain bf16 transcription.

# (dims, hidden, folds, rows, fusion, seed): chip_smoke's phase 6a
# problems, seeds included. A seed can put a LeakyReLU pre-activation
# within fp32 rounding of zero, where fp32 and fp64 take different
# derivatives (0.01 against 1) for a whole row: these seeds have none.
STEP_CASES = {
    "flagship": ([90, 90, 90, 270], [110, 110], 5, 256, "gpoe", 264),
    "poe": ([40, 60, 30], [32, 32], 2, 100, "poe", 103),
    "moe": ([40, 60, 30], [32, 32], 2, 100, "moe", 103),
    "mopoe": ([40, 60, 30], [32, 32], 2, 100, "mopoe", 105),
    "1hidden": ([40, 60, 30], [48], 2, 100, "gpoe", 108),
    "3hidden": ([40, 60, 30], [64, 110, 32], 2, 100, "gpoe", 108),
    "1modality": ([90], [110, 110], 2, 100, "gpoe", 110),
    "ppmi": ([3485] * 3, [110, 110], 1, 256, "gpoe", 260),
    # no width a multiple of 4 (C 29 and Z 10 neither): every tensor of the
    # padded layout is wider than its true shape; ragged rows
    "ragged": ([37, 90, 271], [110, 110], 2, 100, "gpoe", 113),
    "ragged-c2": ([37, 90, 271], [110, 57], 2, 75, "poe", 93),
}
# (c_dim, z_dim) of the cases that do not take the CLIs' 29 and 10
STEP_WIDTHS = {"ragged-c2": (2, 7)}


def _step_problem(cuda, dims, hidden, folds, rows, seed, c_dim=29, z_dim=10):
    from multi_modal_normative_modeling_tpu_torch.interop import (
        packed_from_model,
    )
    from multi_modal_normative_modeling_tpu_torch.models.stacked import (
        StackedMultimodalCVAE,
    )

    rng = np.random.default_rng(seed)
    model = build_model("cVAE_multimodal", dims, hidden, z_dim, c_dim,
                        len(dims), folds=folds,
                        generator=torch.Generator().manual_seed(seed),
                        device=cuda)
    stacked = StackedMultimodalCVAE(dims, hidden, z_dim, c_dim, len(dims))
    x = stacked.pack_inputs([_rows(rng, folds, rows, d) for d in dims])
    if c_dim == 29:
        # one-hot age (27 bins) and sex, as the CLIs feed (and chip_smoke)
        c = torch.zeros(folds, rows, c_dim)
        idx = torch.arange(rows)
        for f in range(folds):
            c[f, idx, torch.from_numpy(rng.integers(0, 27, rows))] = 1.0
            c[f, idx, torch.from_numpy(27 + rng.integers(0, 2, rows))] = 1.0
    else:
        c = _rows(rng, folds, rows, c_dim)
    eps = _rows(rng, folds, rows, z_dim).to(cuda)
    mask = torch.ones(folds, rows)
    for f in range(folds):
        mask[f, max(rows - 2 - f, 1):] = 0.0
    return stacked, packed_from_model(model, stacked), x.to(cuda), \
        c.to(cuda), eps, mask.to(cuda)


def _plain64(reference, named, batch):
    losses, grads = reference({k: v.double() for k, v in named.items()},
                              *[t.double() for t in batch])
    return ({k: v.float() for k, v in losses.items()},
            {k: v.float() for k, v in grads.items()})


def _leaf_error(got, want):
    return ((got.double() - want.double()).norm()
            / (want.double().norm() + 1e-12)).item()


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_fused_train_step_kernel_matches_plain(cuda, case):
    from multi_modal_normative_modeling_tpu_torch.kernels.train_step import (
        FusedTrainStep,
    )

    dims, hidden, folds, rows, combine, seed = STEP_CASES[case]
    c_dim, z_dim = STEP_WIDTHS.get(case, (29, 10))
    stacked, packed, x, c, eps, mask = _step_problem(
        cuda, dims, hidden, folds, rows, seed, c_dim=c_dim, z_dim=z_dim)
    step = FusedTrainStep(stacked, combine)
    named = step.pad_params(packed)
    xx, cc, rm, nv = step.pack_batch(x, c, mask)
    batch = (xx, cc, eps, rm, nv)
    before = kernels.fused_train_step.launches
    losses, grads = step.loss_and_grads_padded(named, *batch)
    assert kernels.fused_train_step.launches == before + 1
    ref_losses, ref_grads = _plain64(step.reference, named, batch)
    for k in losses:
        torch.testing.assert_close(losses[k], ref_losses[k], rtol=1e-5,
                                   atol=0.0)
    tol = (dict(rtol=2e-3, atol=2e-5) if max(dims) > 1000
           else dict(rtol=1e-3, atol=1e-5))
    for k in grads:
        torch.testing.assert_close(grads[k], ref_grads[k], **tol)
    again = step.loss_and_grads_padded(named, *batch)[1]
    for k in grads:
        assert torch.equal(grads[k], again[k]), k
    # every padded entry of every gradient is exactly zero
    ones = step.widen({k: torch.ones_like(v)
                       for k, v in step.strip(named).items()})
    for k in grads:
        assert torch.count_nonzero(grads[k][ones[k] == 0]) == 0, k
    # the flat buffer is the named gradients back to back, and what
    # autograd takes through StepFunction
    flat = step.loss_and_grads_flat(named, *batch)[1]
    assert torch.equal(flat, torch.cat([grads[k].reshape(-1)
                                        for k in step._param_names]))
    leaves = [torch.nn.Parameter(named[k].clone())
              for k in step._param_names]
    total, _ = step.loss_fn(leaves)(
        {"x": xx, "c": cc, "rm": rm, "nvalid": nv}, eps)
    auto = torch.autograd.grad(total.sum(), leaves)
    assert torch.equal(flat, torch.cat([g.reshape(-1) for g in auto]))
    # both routes give the same gradients within the summation order
    for route in (1, 264):
        step.route = route
        forced = step.loss_and_grads_padded(named, *batch)[1]
        for k in grads:
            torch.testing.assert_close(forced[k], ref_grads[k], **tol)
    step.route = 0
    if len(dims) > 1:
        # padded columns of the narrower modalities get exactly zero
        narrow = dims.index(min(dims))
        assert torch.count_nonzero(
            grads["lvo"][:, narrow, min(dims):]) == 0
        assert torch.count_nonzero(
            grads["enc_w0"][:, narrow, min(dims):max(dims)]) == 0


def test_tiled_train_step_kernel_matches_k5_and_plain(cuda):
    from multi_modal_normative_modeling_tpu_torch.kernels.train_step import (
        FusedTrainStep,
    )
    from multi_modal_normative_modeling_tpu_torch.kernels.train_step_tiled import (  # noqa: E501
        TiledFusedTrainStep,
    )

    dims, hidden, folds, rows, combine, _ = STEP_CASES["flagship"]
    stacked, packed, x, c, eps, mask = _step_problem(cuda, dims, hidden,
                                                     folds, rows, seed=11)
    k5 = FusedTrainStep(stacked, combine)
    named = k5.pad_params(packed)
    xx, cc, rm, nv = k5.pack_batch(x, c, mask)
    batch = (xx, cc, eps, rm, nv)
    l5, g5 = k5.loss_and_grads_padded(named, *batch)
    ref_g = _plain64(k5.reference, named, batch)[1]

    t32 = TiledFusedTrainStep(stacked, combine, tile_b=64)
    before = kernels.tiled_fused_train_step.launches
    lt, gt = t32.loss_and_grads_padded(named, *batch)
    assert kernels.tiled_fused_train_step.launches == before + 1
    torch.testing.assert_close(lt["total"], l5["total"], rtol=1e-5, atol=0.0)
    for k in gt:
        torch.testing.assert_close(gt[k], g5[k], rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(gt[k], ref_g[k], rtol=1e-3, atol=1e-5)

    # bf16 in its own layout (widths padded to 16)
    t16 = TiledFusedTrainStep(stacked, combine, tile_b=64,
                              compute_dtype=torch.bfloat16)
    _check_tiled_against_own_plain(t16, packed, x, c, eps, mask)

    # bf16 against fp32 at tests/test_train_step_tiled.py's shape
    stacked, packed, x, c, eps, mask = _step_problem(
        cuda, [24, 40, 16], [12, 12], 1, 20, seed=4, c_dim=5, z_dim=6)
    small = TiledFusedTrainStep(stacked, "gpoe", tile_b=16,
                                compute_dtype=torch.bfloat16)
    named = small.pad_params(packed)
    xx, cc, rm, nv = small.pack_batch(x, c, mask)
    batch = (xx, cc, small.pad_eps(eps), rm, nv)
    lb, gb = small.loss_and_grads_padded(named, *batch)
    f32 = FusedTrainStep(stacked, "gpoe")
    x32, c32, rm32, nv32 = f32.pack_batch(x, c, mask)
    lf, gf = _plain64(f32.reference, f32.pad_params(packed),
                      (x32, c32, eps, rm32, nv32))
    assert ((lb["total"] - lf["total"]).abs()
            / lf["total"].abs()).max().item() < 2e-2
    gb, gf = small.strip(gb), f32.strip(gf)
    assert max(_leaf_error(gb[k], gf[k]) for k in gb) < 6e-2


def _check_tiled_against_own_plain(step, packed, x, c, eps, mask):
    """K6 against its own plain version (the tile-loop transcription with
    the same cast points, in fp64) in its own padded layout, on the batch
    stored in the operand type; two calls bit-equal; padding zero."""
    named = step.pad_params(packed)
    xx, cc, rm, nv = step.pack_batch(x, c, mask)
    stored = step.cast_batch({"x": xx, "c": cc})
    batch = (stored["x"], stored["c"], step.pad_eps(eps), rm, nv)
    before = kernels.tiled_fused_train_step.launches
    losses, grads = step.loss_and_grads_padded(named, *batch)
    assert kernels.tiled_fused_train_step.launches == before + 1
    lp, gp = _plain64(step.reference, step.cast_exec(named), batch)
    bound = 5e-3 if step.compute_dtype == torch.bfloat16 else 1e-4
    assert max(_leaf_error(grads[k], gp[k]) for k in grads) < bound
    assert ((losses["total"] - lp["total"]).abs()
            / lp["total"].abs()).max().item() < bound
    again = step.loss_and_grads_padded(named, *batch)[1]
    ones = step.widen({k: torch.ones_like(v)
                       for k, v in step.strip(named).items()})
    for k in grads:
        assert torch.equal(grads[k], again[k]), k
        assert torch.count_nonzero(grads[k][ones[k] == 0]) == 0, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case,tile_b", [("ragged", 48), ("ragged-c2", 64),
                                         ("flagship", 100)])
def test_tiled_train_step_kernel_at_ragged_widths_and_batches(cuda, case,
                                                              tile_b, dtype):
    """K6 where no width is a multiple of 4 and where the batch is not a
    multiple of 64 or of the tile (100 rows in tiles of 48, 75 rows in one
    tile of 64, 256 rows in tiles of 100)."""
    from multi_modal_normative_modeling_tpu_torch.kernels.train_step_tiled import (  # noqa: E501
        TiledFusedTrainStep,
    )

    dims, hidden, folds, rows, combine, seed = STEP_CASES[case]
    c_dim, z_dim = STEP_WIDTHS.get(case, (29, 10))
    stacked, packed, x, c, eps, mask = _step_problem(
        cuda, dims, hidden, folds, rows, seed, c_dim=c_dim, z_dim=z_dim)
    step = TiledFusedTrainStep(stacked, combine, tile_b=tile_b,
                               compute_dtype=dtype)
    _check_tiled_against_own_plain(step, packed, x, c, eps, mask)


def test_fused_train_step_refuses_what_it_does_not_take(cuda):
    from multi_modal_normative_modeling_tpu_torch.kernels.train_step import (
        FusedTrainStep,
    )

    stacked, packed, x, c, eps, mask = _step_problem(
        cuda, [40, 60], [32], 1, 16, seed=0)
    step = FusedTrainStep(stacked, "gpoe")
    named = step.pad_params(packed)
    xx, cc, rm, nv = step.pack_batch(x, c, mask)
    with pytest.raises(ValueError, match="contiguous"):
        step.loss_and_grads_padded(named, xx, cc.mT.contiguous().mT, eps,
                                   rm, nv)
    with pytest.raises(ValueError, match="float32"):
        step.loss_and_grads_padded(named, xx, cc, eps.double(), rm, nv)
    with pytest.raises(ValueError, match="expected"):
        step.loss_and_grads_padded(named, xx[:, :, :8].contiguous(), cc, eps,
                                   rm, nv)


def _packed_leaves(tree):
    """The tensors of a packed tree, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _packed_leaves(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in _packed_leaves(v)]
    return [tree]


def test_fused_trainer_matches_plain_trainer(cuda):
    """A few flagship-width steps through FusedFoldTrainer (K5) stay within
    tests/test_fused_cli.py's trajectory bounds of MultiFoldTrainer with
    the plain loss (same init, same eps): logs rtol 2e-4, parameters rtol
    5e-3 / atol 5e-5; one K5 launch per step."""
    from multi_modal_normative_modeling_tpu_torch.interop import (
        packed_from_model,
    )
    from multi_modal_normative_modeling_tpu_torch.parallel import (
        MultiFoldTrainer,
        stack_fold_batches,
    )
    from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
    from multi_modal_normative_modeling_tpu_torch.train.fused import (
        FusedFoldTrainer,
    )

    dims, sizes = [90, 270], [300, 260]
    rng = np.random.default_rng(3)
    data = [[rng.standard_normal((s, d), dtype=np.float32) for d in dims]
            for s in sizes]
    cov = [rng.standard_normal((s, 29), dtype=np.float32) for s in sizes]
    eps = torch.randn(6, 2, 256, 10,
                      generator=torch.Generator().manual_seed(0)).to(cuda)
    config = TrainConfig(epochs=3, batch_size=256)

    def model():
        return build_model("cVAE_multimodal", dims, [110, 110], 10, 29, 2,
                           folds=2, generator=torch.Generator().manual_seed(1),
                           device=cuda)

    plain = model()
    logs_p = MultiFoldTrainer(plain, config, 300).run(
        stack_fold_batches(data, [[c] * 2 for c in cov], 256), eps=eps)
    fused = model()
    trainer = FusedFoldTrainer(fused, config, 300)
    batches = trainer.batches(data, cov, cuda)
    before = kernels.fused_train_step.launches
    trained, logs_k = trainer.run(packed_from_model(fused, trainer.stacked),
                                  batches, eps=eps)
    assert kernels.fused_train_step.launches == before + 6
    for k in logs_p:
        np.testing.assert_allclose(logs_k[k], logs_p[k], rtol=2e-4)
    want = packed_from_model(plain, trainer.stacked)
    for a, b in zip(_packed_leaves(trained), _packed_leaves(want)):
        torch.testing.assert_close(a, b, rtol=5e-3, atol=5e-5)
