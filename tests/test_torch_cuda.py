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


# (folds, rows, D, C, hidden, Z): ragged rows, 0, 1 and 3 hidden layers, a
# hidden layer wider than a column block, a latent width of 7, 5 folds, and
# heads too wide for the kernel's one-pass route (40 rows of 460 weights)
ENCODER_SPLIT_CASES = [(5, 37, 90, 29, [64, 110, 32], 10),
                       (3, 65, 45, 3, [], 10),
                       (1, 40, 270, 29, [130], 7),
                       (2, 70, 270, 29, [110, 110], 10),
                       (2, 33, 90, 29, [460], 20)]


@pytest.mark.parametrize("splits", [1, 2, None],
                         ids=["one", "two", "the plan's"])
@pytest.mark.parametrize("folds,rows,d,c_dim,hidden,z", ENCODER_SPLIT_CASES)
def test_encoder_kernel_matches_fp64_at_forced_splits(cuda, folds, rows, d,
                                                      c_dim, hidden, z,
                                                      splits):
    """K1 against the plain code evaluated in fp64 (the fp32 plain version
    on the card is the weaker reference), with the reduction of the first
    layer in one block, cut in two, and cut as the plan cuts it; two calls
    bit-equal; one launch counted per call."""
    rng = np.random.default_rng(rows + d)
    enc = Encoder(d, hidden, z, c_dim, True, folds,
                  torch.Generator().manual_seed(0), cuda)
    x, c = _rows(rng, folds, rows, d).to(cuda), _rows(
        rng, folds, rows, c_dim).to(cuda)
    layers = (enc.hidden_layers(), enc.mu.pair(), enc.logvar.pair())
    with torch.no_grad():
        before = kernels.fused_encoder.launches
        got = kernels.fused_encoder(*layers, x, c, True, splits=splits)
        assert kernels.fused_encoder.launches == before + 1
        again = kernels.fused_encoder(*layers, x, c, True, splits=splits)
        want = kernels.encoder_reference(
            [(w.double(), b.double()) for w, b in layers[0]],
            *[tuple(t.double() for t in head) for head in layers[1:]],
            x.double(), c.double(), True)
    for g, a, w in zip(got, again, want):
        assert g.shape == (folds, rows, z) and torch.equal(g, a)
        torch.testing.assert_close(g.double(), w, **TOL)


def test_encoder_kernel_with_no_rows_launches_nothing(cuda):
    enc = Encoder(90, [110], 10, 29, device=cuda)
    before = kernels.fused_encoder.launches
    mu, lv = enc.fused(torch.zeros(1, 0, 90, device=cuda),
                       torch.zeros(1, 0, 29, device=cuda))
    assert mu.shape == lv.shape == (1, 0, 10)
    assert kernels.fused_encoder.launches == before


def test_encoder_kernel_refuses_a_slice_too_large_for_a_block(cuda):
    """One split of a PPMI-wide input would need 446 KB of shared memory."""
    enc = Encoder(3485, [110], 10, 2, device=cuda)
    x = torch.zeros(1, 8, 3485, device=cuda)
    c = torch.zeros(1, 8, 2, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.fused_encoder(enc.hidden_layers(), enc.mu.pair(),
                              enc.logvar.pair(), x, c, True, splits=1)


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


@pytest.mark.parametrize("name,combine", [
    ("mmJSD", "poe"), ("mmJSD", "gpoe"), ("mvtCAE", "poe"),
    ("mvtCAE", "gpoe")])
def test_zoo_scoring_call_runs_through_the_kernels(cuda, name, combine):
    """The skeleton variants score through K1 and K2 with their own fusion
    between them: one launch of each per modality, against the plain path
    evaluated in fp64 on the same eps."""
    import copy

    dims = [90, 90, 90]
    model = build_model(name, dims, [110, 110], 10, 29, 3, folds=5,
                        generator=torch.Generator().manual_seed(0),
                        device=cuda)
    rng = np.random.default_rng(1)
    xes = [_rows(rng, 5, 200, d).to(cuda) for d in dims]
    cs = [_rows(rng, 5, 200, 29).to(cuda)] * 3
    eps = _rows(rng, 5, 200, 10).to(cuda)
    kernels.reset_launch_counts()
    recons, devs = model.pred_recon_fused(xes, cs, combine, eps=eps)
    assert kernels.fused_encoder.launches == 3
    assert kernels.fused_pred_deviation.launches == 3
    model64 = copy.deepcopy(model).double()
    with torch.no_grad():
        ref = model64.pred_recon([x.double() for x in xes],
                                 [c.double() for c in cs], combine,
                                 eps=eps.double())
    for m in range(3):
        torch.testing.assert_close(recons[m], ref[m].float(), rtol=2e-4,
                                   atol=2e-5)
        torch.testing.assert_close(
            devs[m], model64.reconstruction_deviation(
                xes[m].double(), ref[m]).float(), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("name,combine", [
    ("cVAE_multimodal", "gpoe"), ("cVAE_multimodal", "poe"),
    ("mmJSD", "poe"), ("mvtCAE", "poe")])
def test_latent_stats_fused_runs_through_the_encoder_kernel(cuda, name,
                                                            combine):
    """The scoring surfaces' latent path: one K1 launch per modality at a
    request's 64 rows over 10 folds, against latent_stats evaluated in fp64
    at the scoring call's bound."""
    import copy

    dims = [90, 90, 90, 270]
    model = build_model(name, dims, [110, 110], 10, 29, 4, folds=10,
                        generator=torch.Generator().manual_seed(4),
                        device=cuda)
    rng = np.random.default_rng(4)
    xes = [_rows(rng, 10, 64, d).to(cuda) for d in dims]
    cs = [torch.from_numpy(np.eye(29, dtype=np.float32)[
        rng.integers(0, 29, (10, 64))]).to(cuda)] * 4
    kernels.reset_launch_counts()
    mu, var = model.latent_stats_fused(xes, cs, combine)
    assert kernels.fused_encoder.launches == 4
    assert kernels.fused_pred_deviation.launches == 0
    model64 = copy.deepcopy(model).double()
    with torch.no_grad():
        mu64, var64 = model64.latent_stats([x.double() for x in xes],
                                           [c.double() for c in cs], combine)
    torch.testing.assert_close(mu, mu64.float(), rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(var, var64.float(), rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def scoring_project(tmp_path_factory):
    """A small UCA-gPoE project trained on the CPU by the port (2 folds),
    with an ids file of every subject."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import pandas as pd

    from multi_modal_normative_modeling_tpu_torch.cli import train_supervised
    from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
        make_synthetic_resource,
    )

    root = tmp_path_factory.mktemp("scoring_project")
    make_synthetic_resource(root, "ADNI", n_hc=40, n_disease={0: 16, 1: 16},
                            with_early_fusion=True)
    train_supervised.run(["-R", "ADNI", "-P", "UCA-gPoE", "-E", "3", "-K",
                          "2", "-H", "16", "16", "6", "--device", "cpu"],
                         project_root=root)
    pd.read_csv(root / "data" / "ADNI" / "y.csv")[["IID"]].to_csv(
        root / "ids.csv", index=False)
    return root


def test_score_cli_on_the_card_matches_the_cpu(cuda, scoring_project):
    """cli/score.py through K1 and K2 (and K1 for the latent column)
    against --device cpu, on the same noise: one launch of each per
    modality for the scoring call, two more K1 per modality for --latent."""
    from multi_modal_normative_modeling_tpu_torch.cli import score

    flags = ["-R", "ADNI", "-P", "UCA-gPoE", "-K", "2", "--ids",
             str(scoring_project / "ids.csv"), "--output", "", "--latent"]
    cpu = score.run(flags + ["--device", "cpu"], project_root=scoring_project)
    kernels.reset_launch_counts()
    card = score.run(flags + ["--device", "cuda"],
                     project_root=scoring_project)
    assert kernels.fused_encoder.launches == 4 + 8
    assert kernels.fused_pred_deviation.launches == 4
    for name in ("deviation", "latent_deviation"):
        np.testing.assert_allclose(card[name], cpu[name], rtol=2e-4,
                                   atol=2e-5)


def test_service_on_the_card_matches_the_cpu(cuda, scoring_project):
    """ScoringService on the card against the same service on the CPU:
    ids, raw, roi, fold and latent requests; K1 and K2 once per modality
    for a request, K1 once more per modality for a latent one."""
    from multi_modal_normative_modeling_tpu_torch.cli import serve

    services = [serve.ScoringService("ADNI", "UCA-gPoE", n_splits=2,
                                     project_root=scoring_project,
                                     device=device)
                for device in ("cpu", "cuda")]
    ids = list(services[0]._frames[0].index[:70])
    assert services[1].health()["backend"] == "cuda"
    services[1].score_ids(ids[:1], latent=True)   # the latent statistics
    for kwargs in (dict(), dict(roi=True), dict(fold=1, roi=True),
                   dict(latent=True)):
        kernels.reset_launch_counts()
        card = services[1].score_ids(ids, **kwargs)
        assert kernels.fused_encoder.launches == 4 * (1 + ("latent" in kwargs))
        assert kernels.fused_pred_deviation.launches == 4
        cpu = services[0].score_ids(ids, **kwargs)
        for key in ("deviation", "roi", "latent_deviation", "latent_per_dim"):
            if key in cpu:
                np.testing.assert_allclose(card[key], cpu[key], rtol=2e-4,
                                           atol=2e-5)
    frame = services[1]._frames
    rows = [f.loc[ids[:5]] for f in frame]
    raw = services[1].score_raw(
        {name: r[cols].to_numpy(float).tolist() for name, r, cols in zip(
            services[1].dataset_names, rows, services[1].columns)},
        {"AGE": rows[-1]["AGE"].tolist(),
         "PTGENDER": rows[-1]["PTGENDER"].tolist()})
    np.testing.assert_allclose(raw["deviation"],
                               services[1].score_ids(ids[:5])["deviation"],
                               rtol=1e-6)
    # column-major features (a matrix taken from a frame) reach the
    # kernels contiguous, with the same answer
    from multi_modal_normative_modeling_tpu_torch.infer import ensemble

    state = services[1].state
    feats = [np.asfortranarray(r[cols].to_numpy(np.float32))
             for r, cols in zip(rows, services[1].columns)]
    covs = torch.zeros((2, 5, 29), device=cuda)
    covs[:, :, 0] = covs[:, :, 27] = 1.0
    eps = ensemble.fold_eps(state.seeds, 5, 6, cuda)
    got = ensemble.fold_infer(state, covs, eps,
                              [torch.from_numpy(f).to(cuda) for f in feats])
    want = ensemble.fold_infer(state, covs, eps, [
        torch.from_numpy(np.ascontiguousarray(f)).to(cuda) for f in feats])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("name,latent", [("DMVAE", 10), ("DMVAE", 40),
                                         ("WeightedDMVAE", 40),
                                         ("mmVAEPlus", 10), ("mvtCAE", 10),
                                         ("mmJSD", 10)])
def test_zoo_training_on_the_card_matches_the_cpu(cuda, name, latent):
    """A few plain steps of a zoo model on the card against the same steps
    on the CPU, from the same init and eps, a ragged two-fold cohort whose
    small fold meets an all-padding batch; of the kernels only MaskedAdam's
    (K7) is launched, once a step on the card."""
    import warnings

    from multi_modal_normative_modeling_tpu_torch.parallel import (
        MultiFoldTrainer,
        stack_fold_batches,
    )
    from multi_modal_normative_modeling_tpu_torch.train import TrainConfig

    dims = [90, 90, 90]
    rng = np.random.default_rng(2)
    cohorts = [([rng.standard_normal((n, d)).astype(np.float32)
                 for d in dims],
                [rng.standard_normal((n, 29)).astype(np.float32)] * 3)
               for n in (70, 40)]
    batches = stack_fold_batches([c[0] for c in cohorts],
                                 [c[1] for c in cohorts], 32)
    assert not batches["valid"][1, -1]
    config = TrainConfig(epochs=3, batch_size=32, combine="poe")
    runs = {}
    kernels.reset_launch_counts()
    for device in ("cpu", cuda):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            model = build_model(name, dims, [110, 110], latent, 29, 3,
                                folds=2,
                                generator=torch.Generator().manual_seed(3),
                                device=device)
        eps = torch.randn((9, 2, 32, model.noise_dim),
                          generator=torch.Generator().manual_seed(4))
        logs = MultiFoldTrainer(model, config, 70).run(batches, eps=eps)
        runs[str(device)] = (logs, {k: v.cpu()
                                    for k, v in model.state_dict().items()})
    steps = config.epochs * batches["mask"].shape[1]
    assert {k.__name__: k.launches for k in kernels.KERNELS
            if k.launches} == {"masked_adam": steps}
    (logs_c, state_c), (logs_g, state_g) = runs["cpu"], runs["cuda"]
    assert set(logs_g) == set(model.log_keys)
    for k in logs_c:
        assert np.isfinite(logs_g[k]).all()
        np.testing.assert_allclose(logs_g[k], logs_c[k], rtol=1e-4)
    for k in state_c:
        torch.testing.assert_close(state_g[k], state_c[k], rtol=5e-3,
                                   atol=1e-5)


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


# the wide-hidden route (hidden widths over 440; csrc/train_step.cuh's
# DecSmem<2>): (dims, hidden, folds, rows, fusion, seed, latent). The first
# is the ADHD cell's step ([116, 116], -H 460 460 40, 256 rows) at 2 folds.
WIDE_HIDDEN_CASES = {
    "adhd-h460-z40": ([116, 116], [460, 460], 2, 256, "gpoe", 460, 40),
    "h444-z10": ([116, 116], [444, 444], 2, 100, "gpoe", 444, 10),
    "3x460-z10": ([90, 270], [460, 460, 460], 2, 100, "gpoe", 4603, 10),
    # the stated limit, MAX_WIDTH_FP32: the widest hidden layer, and the
    # widest latent, whose [dmu | dlv] tile is then the widest tile
    "h648-z10": ([116, 116], [648], 2, 100, "gpoe", 648, 10),
    "h110-z324": ([116, 116], [110], 2, 100, "gpoe", 324, 324),
}


@pytest.mark.parametrize("case", list(WIDE_HIDDEN_CASES))
def test_wide_hidden_route_matches_plain(cuda, case):
    """K5 where three activation tiles do not fit a block: the plan takes
    the wide-hidden route (the library's plan as train_step.py computes
    it), one launch a step counted under it, the losses and gradients
    within the step's tolerances of the plain version in fp64, two calls
    bit-equal, padding zero; the mean head on the grid too (route 264)."""
    from multi_modal_normative_modeling_tpu_torch.kernels import train_step

    dims, hidden, folds, rows, combine, seed, z = WIDE_HIDDEN_CASES[case]
    stacked, packed, x, c, eps, mask = _step_problem(
        cuda, dims, hidden, folds, rows, seed, z_dim=z)
    step = train_step.FusedTrainStep(stacked, combine)
    plan = train_step.plan(step, folds, rows)
    assert plan["dec_tiles"] == train_step.decoder_tiles(hidden, z) == 2
    assert plan["dec_smem"] == train_step.wide_hidden_smem_bytes(hidden, z)
    assert plan["route"] == "wide_hidden"
    named = step.pad_params(packed)
    xx, cc, rm, nv = step.pack_batch(x, c, mask)
    batch = (xx, cc, eps, rm, nv)
    kernels.reset_launch_counts()
    losses, grads = step.loss_and_grads_padded(named, *batch)
    assert kernels.fused_train_step.launches == 1
    assert kernels.fused_train_step.route_launches == {
        "fused": 0, "wide": 0, "wide_hidden": 1}
    ref_losses, ref_grads = _plain64(step.reference, named, batch)
    for k in losses:
        torch.testing.assert_close(losses[k], ref_losses[k], rtol=1e-5,
                                   atol=0.0)
    for k in grads:
        torch.testing.assert_close(grads[k], ref_grads[k], rtol=1e-3,
                                   atol=1e-5)
    again = step.loss_and_grads_padded(named, *batch)[1]
    ones = step.widen({k: torch.ones_like(v)
                       for k, v in step.strip(named).items()})
    for k in grads:
        assert torch.equal(grads[k], again[k]), k
        assert torch.count_nonzero(grads[k][ones[k] == 0]) == 0, k
    step.route = 264
    assert train_step.plan(step, folds, rows)["wide"] == 1
    forced = step.loss_and_grads_padded(named, *batch)[1]
    step.route = 0
    for k in grads:
        torch.testing.assert_close(forced[k], ref_grads[k], rtol=1e-3,
                                   atol=1e-5)


@pytest.mark.parametrize("case", ["flagship", "ragged", "3hidden", "ppmi"])
def test_wide_hidden_route_forced_is_bit_equal_to_three_tiles(cuda, case):
    """At widths where three tiles fit, the wide-hidden route forced gives
    the one-pass route's (and at PPMI width the wide route's) losses and
    gradients bit for bit: the same products in the same order."""
    from multi_modal_normative_modeling_tpu_torch.kernels import train_step

    dims, hidden, folds, rows, combine, seed = STEP_CASES[case]
    c_dim, z_dim = STEP_WIDTHS.get(case, (29, 10))
    stacked, packed, x, c, eps, mask = _step_problem(
        cuda, dims, hidden, folds, rows, seed, c_dim=c_dim, z_dim=z_dim)
    step = train_step.FusedTrainStep(stacked, combine)
    named = step.pad_params(packed)
    xx, cc, rm, nv = step.pack_batch(x, c, mask)
    batch = (xx, cc, eps, rm, nv)
    auto = train_step.plan(step, folds, rows)
    assert auto["dec_tiles"] == 3
    kernels.reset_launch_counts()
    losses, grads = step.loss_and_grads_padded(named, *batch)
    step.dec_tiles = 2
    plan = train_step.plan(step, folds, rows)
    assert (plan["route"], plan["wide"]) == ("wide_hidden", auto["wide"])
    two_losses, two = step.loss_and_grads_padded(named, *batch)
    step.dec_tiles = 0
    assert kernels.fused_train_step.route_launches == {
        "fused": 1 - auto["wide"], "wide": auto["wide"], "wide_hidden": 1}
    for k in losses:
        assert torch.equal(losses[k], two_losses[k]), k
    for k in grads:
        assert torch.equal(grads[k], two[k]), k


def test_fused_trainer_counts_and_spans_the_wide_hidden_route(cuda):
    """FusedFoldTrainer at the ADHD cell's widths: one K5 launch a step,
    each under the wide-hidden route's count; under a profiler each sits in
    an mmnm.step.kernel.wide_hidden range inside an mmnm.step.kernel one."""
    from torch.profiler import ProfilerActivity, profile

    from multi_modal_normative_modeling_tpu_torch.interop import (
        packed_from_model,
    )
    from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
    from multi_modal_normative_modeling_tpu_torch.train.fused import (
        FusedFoldTrainer,
    )

    dims, sizes = [116, 116], [300, 260]
    rng = np.random.default_rng(5)
    data = [[rng.standard_normal((s, d), dtype=np.float32) for d in dims]
            for s in sizes]
    cov = [rng.standard_normal((s, 29), dtype=np.float32) for s in sizes]
    config = TrainConfig(epochs=2, batch_size=256)
    model = build_model("cVAE_multimodal", dims, [460, 460], 40, 29, 2,
                        folds=2, generator=torch.Generator().manual_seed(1),
                        device=cuda)
    trainer = FusedFoldTrainer(model, config, 300)
    assert trainer.kernel == "single"
    batches = trainer.batches(data, cov, cuda)
    packed = packed_from_model(model, trainer.stacked)
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.run(packed, batches)
    torch.cuda.synchronize()
    steps = 2 * 2
    assert kernels.fused_train_step.launches == steps
    assert kernels.fused_train_step.route_launches == {
        "fused": 0, "wide": 0, "wide_hidden": steps}
    spans = {}
    for e in prof.events():
        if e.name.startswith("mmnm.step.kernel"):
            spans.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    inner = spans["mmnm.step.kernel.wide_hidden"]
    outer = spans["mmnm.step.kernel"]
    assert len(inner) == len(outer) == steps
    for (a, b), (lo, hi) in zip(sorted(inner), sorted(outer)):
        assert lo <= a <= b <= hi


# K5's gradients are held to rtol 1e-3 / atol 1e-5: that fixes no sign of
# a gradient at or under the atol, and Adam moves an entry by about lr a
# step whatever its gradient's size
ROUNDED_GRAD = 1e-5
# a LeakyReLU pre-activation this near zero may round to either side in
# fp32, where the two sides take derivatives 0.01 and 1 for that row
ROUNDED_PRE = 2e-7


def _adhd_cli_runs(root, monkeypatch, runs, epochs=3, step_fns=None):
    """train_supervised -R ADHD -P SE-gPoE -K 10 -H 460 460 40 on a
    synthetic ADHD cohort (441 controls a training fold, 2 steps an
    epoch), once for each of ``runs``, a dict of {name: extra flags}, in
    ``root/<name>``; a run named in ``step_fns`` takes that function for
    FusedTrainStep.loss_and_grads_flat. Returns {name: {logs, params,
    start (the init), least (the least |gradient| of each parameter over
    the run's steps; plain runs only), steps, route_launches,
    adam_launches}}, logs, params, start and least as lists over folds."""
    import shutil

    from multi_modal_normative_modeling_tpu_torch.cli import (
        common,
        train_supervised,
    )
    from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
        make_synthetic_resource,
    )
    from multi_modal_normative_modeling_tpu_torch.interop import (
        params_to_jax,
    )
    from multi_modal_normative_modeling_tpu_torch.kernels.train_step import (
        FusedTrainStep,
    )
    from multi_modal_normative_modeling_tpu_torch.train.trainer import (
        MaskedAdam,
    )

    emit, init = common.emit_fold_artifacts, train_supervised.default_init
    step_flat = MaskedAdam.step_flat
    run = {}

    def keep(model_dir, per_fold_logs, per_fold_params, *args, **kw):
        run.update(logs=per_fold_logs, params=per_fold_params)
        return emit(model_dir, per_fold_logs, per_fold_params, *args, **kw)

    def record(model, *args):
        init(model, *args)
        run.update(model=model, start=[params_to_jax(model, fold=f)
                                       for f in range(10)])

    def least_grad(adam, g, valid):
        assert bool(valid.all())   # every fold takes every step
        if run.get("adam") is not adam:
            run.update(adam=adam, steps=0)
            adam.least = g.abs()
        else:
            torch.minimum(adam.least, g.abs(), out=adam.least)
        run["steps"] += 1
        step_flat(adam, g, valid)

    monkeypatch.setattr(common, "emit_fold_artifacts", keep)
    monkeypatch.setattr(train_supervised, "default_init", record)
    monkeypatch.setattr(MaskedAdam, "step_flat", least_grad)
    first, out = None, {}
    for name, flags in runs.items():
        if first is None:
            make_synthetic_resource(root / name, "ADHD", n_hc=490,
                                    n_disease={0: 30, 2: 30})
            first = name
        else:
            shutil.copytree(root / first / "data", root / name / "data")
        run.clear()
        kernels.reset_launch_counts()
        with monkeypatch.context() as m:
            if name in (step_fns or {}):
                m.setattr(FusedTrainStep, "loss_and_grads_flat",
                          step_fns[name])
            train_supervised.run(["-R", "ADHD", "-P", "SE-gPoE", "-K", "10",
                                  "-E", str(epochs), "-H", "460", "460",
                                  "40"] + flags, project_root=root / name)
        torch.cuda.synchronize()
        got = {k: run[k] for k in ("logs", "params", "start", "steps")}
        got["route_launches"] = dict(kernels.fused_train_step.route_launches)
        got["adam_launches"] = kernels.masked_adam.launches
        adam, model = run["adam"], run["model"]
        if adam.params[0] is next(model.parameters()):
            # the plain path trained its model in place, in views of its
            # Adam's buffer: that buffer, overwritten, reads out in the
            # params' layout
            with torch.no_grad():
                adam.flat.copy_(adam.least)
                got["least"] = [params_to_jax(model, fold=f)
                                for f in range(10)]
        out[name] = got
    return out


def _within(got, want, rtol, atol):
    return bool(((got.double() - want.double()).abs()
                 <= atol + rtol * want.double().abs()).all())


def _step_checker(flips):
    """A FusedTrainStep.loss_and_grads_flat that holds every step's K5
    losses and gradients, fold by fold, to the plain version in fp64 at
    the same parameters, within the step's tolerances (losses rtol 1e-5,
    gradients rtol 1e-3 / atol 1e-5). Where a fold's gradients fall
    outside, K5 must match the fp64 version with one LeakyReLU derivative
    taken on the other side, at a pre-activation of a valid row within
    ROUNDED_PRE of zero; ``flips`` gets {fold: [(step, layer, modality,
    row, unit)]}."""
    import multi_modal_normative_modeling_tpu_torch.models.stacked as stacked

    from multi_modal_normative_modeling_tpu_torch.kernels.train_step import (
        FusedTrainStep,
    )

    kernel = FusedTrainStep.loss_and_grads_flat
    act = stacked.leaky_relu
    calls = [0]

    def fp64(step, named, batch, flip=None):
        pres = []

        def leaky(a):
            pres.append(a.detach())
            out = act(a)
            if flip is not None and flip[0] == len(pres) - 1:
                other = torch.where(a > 0, 0.01 * a, a)
                at = torch.zeros_like(a, dtype=torch.bool)
                at[flip[1:]] = True
                out = torch.where(at, other, out)
            return out

        with pytest.MonkeyPatch.context() as m:
            m.setattr(stacked, "leaky_relu", leaky)
            losses, grads = step.reference(
                named, *[t.double() for t in batch])
        return losses, grads, pres

    def check(step, named, x, c, eps, rm, nvalid):
        t = calls[0]
        calls[0] += 1
        losses, flat = kernel(step, named, x, c, eps, rm, nvalid)
        grads = step.named_views(flat)
        batch = (x, c, eps, rm, nvalid)
        want_losses, want, pres = fp64(step, named, batch)
        for f in range(x.shape[0]):
            for k in losses:
                assert _within(losses[k][f], want_losses[k][f], 1e-5, 0.0), (
                    t, f, k)
            if all(_within(grads[k][f], want[k][f], 1e-3, 1e-5)
                   for k in grads):
                continue
            valid = torch.nonzero(rm[f] > 0).flatten()
            near = [(i, f, m, int(valid[r]), j) for i, pre in enumerate(pres)
                    for m, r, j in torch.nonzero(
                        pre[f][:, valid].abs() <= ROUNDED_PRE).tolist()]
            matched = [at for at in near if all(
                _within(grads[k][f], g[k][f], 1e-3, 1e-5)
                for g in [fp64(step, named, batch, at)[1]] for k in grads)]
            assert matched, (
                f"step {t} fold {f}: K5's gradients are outside the step's "
                f"tolerances of fp64, and no derivative taken on the other "
                f"side at the {len(near)} pre-activations within "
                f"{ROUNDED_PRE} of zero accounts for them")
            flips.setdefault(f, []).append((t,) + matched[0][:1]
                                           + matched[0][2:])
        return losses, flat

    return check


def test_train_cli_fused_at_the_adhd_grid_widest_point(cuda, tmp_path,
                                                       monkeypatch):
    """train_supervised -R ADHD -P SE-gPoE -K 10 -H 460 460 40
    --fused_train_step, 3 epochs: every step through K5's wide-hidden
    route, no plain step on the card, and each step's K5 losses and
    gradients within the step's tolerances of the plain version in fp64
    at the run's own parameters (``_step_checker``), but where fp32 rounds
    a LeakyReLU pre-activation within ROUNDED_PRE of zero to its other
    side, which the checker shows. Against the CLI's plain path from the
    same init, the flagship's fused-vs-plain bounds, logs rtol 2e-4 and
    parameters rtol 5e-3 / atol 5e-5: total and ll at every epoch of every
    fold; in a fold where K5's step took a derivative on the other side,
    kl up to that step and the parameters by the benchmark's change_gap
    (the gap of the norms of a leaf's change over the run, over the larger
    of the plain change's and the fold's median leaf's) within 1e-2, as
    the paths part from there; in every other fold kl at every epoch and
    every parameter, an entry outside only where the plain run's gradient
    was a rounded zero (at or under ROUNDED_GRAD) in some step, whose sign
    is not fixed, so Adam steps it by about lr either way."""
    flips = {}
    runs = _adhd_cli_runs(tmp_path, monkeypatch,
                          {"fused": ["--fused_train_step"], "plain": []},
                          step_fns={"fused": _step_checker(flips)})
    fused, plain = runs["fused"], runs["plain"]
    steps = fused["steps"]
    assert steps == plain["steps"] == 3 * 2
    assert fused["route_launches"] == {"fused": 0, "wide": 0,
                                       "wide_hidden": steps}
    assert fused["adam_launches"] == steps
    assert "least" not in fused and "least" in plain
    (logs_k, params_k), (logs_p, params_p) = ((r["logs"], r["params"])
                                              for r in (fused, plain))
    assert len(params_k) == len(params_p) == 10
    # each epoch logs its first step's losses, taken before that step's
    # update
    logged = np.arange(3) * 2
    for f in range(10):
        parted = min([t for t, *_ in flips.get(f, [])], default=steps)
        for k in logs_p[f]:
            assert len(logs_k[f][k]) == 3
            upto = logged <= parted if k == "kl" else logged >= 0
            np.testing.assert_allclose(
                np.asarray(logs_k[f][k])[upto],
                np.asarray(logs_p[f][k])[upto], rtol=2e-4,
                err_msg=f"fold {f} {k}")
        leaves = [[np.asarray(x, np.float64) for x in _packed_leaves(t)]
                  for t in (params_k[f], params_p[f], fused["start"][f],
                            plain["start"][f], plain["least"][f])]
        changes = [np.linalg.norm(b - s0) for b, s0 in
                   zip(leaves[1], leaves[2])]
        median = float(np.median(changes))
        for i, (a, b, s0, s1, least) in enumerate(zip(*leaves)):
            assert np.array_equal(s0, s1)
            gap = abs(np.linalg.norm(a - s0) - changes[i]) / max(changes[i],
                                                                  median)
            assert gap <= 1e-2, (f, i, gap)
            if parted < steps:
                continue
            apart = np.abs(a - b) > 5e-5 + 5e-3 * np.abs(b)
            bad = apart & (least > ROUNDED_GRAD)
            assert not bad.any(), (
                f"fold {f} leaf {i}: {int(bad.sum())} entries apart by up "
                f"to {np.abs(a - b)[bad].max():.3e} with a least |gradient| "
                f"of {least[bad].min():.3e} or more")
    # a derivative on the other side is a rare event, not the rule
    assert sum(len(v) for v in flips.values()) <= steps, flips


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


# the three cells' widths, rows cut where the widths stay (PPMI's 2560 a
# fold to 600: three steps, the last of 88 rows): (fold sizes, modality
# widths, covariate width)
CELL_BATCHES = {"adni": ([512] * 10, [90, 90, 90, 270], 29),
                "ppmi": ([600] * 10, [3485] * 3, 29),
                "adhd": ([441] * 10, [116, 116], 29)}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _assert_batches_are(got, want: dict, stored: dict):
    """``got`` (PackedDeviceBatches) holds ``want``'s layout bit for bit,
    x and c as ``stored`` (the storage dtype's)."""
    for k in ("x", "c"):
        assert torch.equal(_bits(getattr(got, k).cpu()),
                           _bits(stored[k].cpu())), k
    for k in ("rm", "nvalid"):
        assert torch.equal(_bits(getattr(got, k).cpu()),
                           _bits(torch.from_numpy(want[k]))), k
    assert np.array_equal(got.valid_host, want["valid"])
    assert torch.equal(got.valid.cpu(), torch.from_numpy(
        want["valid"].astype(np.float32)))


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("cell", list(CELL_BATCHES))
def test_fused_batches_on_the_card_equal_the_cpu_path(cuda, cell,
                                                      precision):
    """``FusedFoldTrainer.batches`` on the card (the ring of page-locked
    slabs, copies that do not wait) against the CPU path and against the
    fold-major layout uploaded whole and cast on the card, bit for bit,
    after K6's cast too; one slab a step through one ring."""
    from test_torch_fused_batches import (
        fold_major_reference,
        packer_case,
    )

    sizes, dims, c_dim = CELL_BATCHES[cell]
    trainer, data, cov = packer_case(sizes, dims, c_dim, 256, precision,
                                     None, "fp32")
    card = trainer.batches(data, cov, cuda)
    cpu = trainer.batches(data, cov, "cpu")
    want = fold_major_reference(trainer.step, data, cov, 256)
    uploaded = trainer.step.cast_batch(
        {k: torch.from_numpy(want[k]).to(cuda) for k in ("x", "c")})
    assert card.x.dtype == (torch.bfloat16 if precision == "bf16"
                            else torch.float32)
    _assert_batches_are(card, want, uploaded)
    _assert_batches_are(cpu, want, uploaded)
    assert trainer.staging_counts == {"slabs": card.n_batches,
                                      "allocations": 1}


def test_fused_batches_ring_is_reused_by_the_next_job(cuda):
    """Two jobs at PPMI's widths back to back on one trainer, the second
    with fewer rows and behind 50 ms of queued work, so that its copies
    wait on the stream while the host packs: one ring, a slab a step, and
    the second job's batches bit for bit its own layout, every padded
    entry zero."""
    from test_torch_fused_batches import (
        fold_major_reference,
        packer_case,
    )

    sizes, dims, c_dim = CELL_BATCHES["ppmi"]
    trainer, data, cov = packer_case(sizes, dims, c_dim, 256, "fp32", None,
                                     "fp32")
    _, small_data, small_cov = packer_case(
        [520] * len(sizes), dims, c_dim, 256, "fp32", None, "fp32",
        seed=1)
    first = trainer.batches(data, cov, cuda)
    torch.cuda._sleep(100_000_000)
    second = trainer.batches(small_data, small_cov, cuda)
    assert first.n_batches == second.n_batches == 3
    assert trainer.staging_counts == {"slabs": 6, "allocations": 1}
    want = fold_major_reference(trainer.step, small_data, small_cov, 256)
    _assert_batches_are(second, want, {k: torch.from_numpy(want[k])
                                       for k in ("x", "c")})
    pad_rows = (second.rm == 0)[:, :, None, :, None].expand_as(second.x)
    assert torch.count_nonzero(second.x[pad_rows]) == 0
    assert torch.count_nonzero(second.x[..., 3485:]) == 0
    assert torch.count_nonzero(second.c[..., c_dim:]) == 0
    assert torch.count_nonzero(second.x[2, :, :, 8:]) == 0


def test_fused_jobs_back_to_back_train_as_on_fresh_trainers(cuda):
    """Two flagship-width jobs (3 folds; 512, then 300 rows a fold) trained
    back to back on one trainer, each job's batches taken behind 50 ms of
    queued work, give the trained parameters and logs of each job on a
    trainer of its own, bit for bit: no slab is rewritten while its copy
    is in flight."""
    from multi_modal_normative_modeling_tpu_torch.interop import (
        packed_from_model,
    )
    from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
    from multi_modal_normative_modeling_tpu_torch.train.fused import (
        FusedFoldTrainer,
    )

    dims = [90, 90, 90, 270]
    rng = np.random.default_rng(7)
    jobs = [([[rng.standard_normal((n, d), dtype=np.float32) for d in dims]
              for _ in range(3)],
             [rng.standard_normal((n, 29), dtype=np.float32)
              for _ in range(3)]) for n in (512, 300)]
    config = TrainConfig(epochs=2, batch_size=256)
    model = build_model("cVAE_multimodal", dims, [110, 110], 10, 29,
                        len(dims), folds=3, device=cuda,
                        generator=torch.Generator().manual_seed(2))
    eps = torch.randn(4, 3, 256, 10,
                      generator=torch.Generator().manual_seed(3)).to(cuda)

    def train(trainer, data, cov):
        torch.cuda._sleep(100_000_000)
        batches = trainer.batches(data, cov, cuda)
        return trainer.run(packed_from_model(model, trainer.stacked),
                           batches, eps=eps)

    shared = FusedFoldTrainer(model, config, 512)
    together = [train(shared, *job) for job in jobs]
    assert shared.staging_counts == {"slabs": 4, "allocations": 1}
    for job, (trained, logs) in zip(jobs, together):
        alone, alone_logs = train(FusedFoldTrainer(model, config, 512), *job)
        for a, b in zip(_packed_leaves(trained), _packed_leaves(alone)):
            assert torch.equal(a, b)
        for k in alone_logs:
            assert np.array_equal(logs[k], alone_logs[k]), k


@pytest.mark.parametrize("unconditioned", [False, True],
                         ids=["cvae", "vae"])
def test_bootstrap_test_stage_on_the_card_matches_the_cpu(cuda, tmp_path,
                                                          unconditioned):
    """cli/bootstrap.py's test stage through K1 and K2, one launch each over
    every replicate (C 29, and C 1 with --unconditioned), against --device
    cpu on the same checkpoints and noise."""
    import pandas as pd

    from multi_modal_normative_modeling_tpu_torch.cli import bootstrap
    from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
        make_synthetic_resource,
    )

    make_synthetic_resource(tmp_path, "ADNI", n_hc=50, n_disease={0: 20})
    flags = ["-R", "ADNI", "-B", "3", "-E", "2", "-H", "16", "16", "4"] + (
        ["--unconditioned"] if unconditioned else [])
    bootstrap.main(["create_ids"] + flags, project_root=tmp_path)
    bootstrap.main(["train"] + flags + ["--device", "cpu"],
                   project_root=tmp_path)
    devs = {}
    for device in ("cpu", "cuda"):
        kernels.reset_launch_counts()
        bootstrap.main(["test"] + flags + ["--device", device],
                       project_root=tmp_path)
        launches = (kernels.fused_encoder.launches,
                    kernels.fused_pred_deviation.launches)
        assert launches == ((1, 1) if device == "cuda" else (0, 0))
        model_dir = tmp_path / "outputs" / "bootstrap_analysis" / (
            "supervised_vae" if unconditioned else "supervised_cvae")
        devs[device] = [pd.read_csv(
            model_dir / f"{b:03d}" / "deviation_3modalities.csv")[
                "Reconstruction deviation"].to_numpy() for b in range(3)]
    for card, cpu in zip(devs["cuda"], devs["cpu"]):
        np.testing.assert_allclose(card, cpu, rtol=2e-4, atol=2e-5)


# ---- slice 12: K1, K2, K3 as custom operators; the exported program --------

@pytest.mark.parametrize("op", ["fused_encoder", "fused_pred_deviation",
                                "fused_decoder_mean"])
@pytest.mark.parametrize("folds,rows,d,c_dim,hidden", CASES[:3])
def test_custom_ops_on_the_card_match_fp64(cuda, op, folds, rows, d, c_dim,
                                           hidden):
    """torch.ops.mmnm.* on CUDA tensors launch the kernels (one count a
    call) and agree with the plain code evaluated in fp64 at the kernels'
    bounds."""
    rng = np.random.default_rng(rows + d)
    gen = torch.Generator().manual_seed(0)
    x, c = _rows(rng, folds, rows, d).to(cuda), _rows(
        rng, folds, rows, c_dim).to(cuda)
    z = _rows(rng, folds, rows, 10).to(cuda)
    if op == "fused_encoder":
        enc = Encoder(d, hidden, 10, c_dim, folds=folds, generator=gen,
                      device=cuda)
        pairs = [*enc.hidden_layers(), enc.mu.pair(), enc.logvar.pair()]
        args = (x, c, [t for p in pairs for t in p], len(hidden), True)
        want = kernels.encoder_reference(
            [tuple(t.double() for t in p) for p in pairs[:-2]],
            *[tuple(t.double() for t in p) for p in pairs[-2:]],
            x.double(), c.double(), True)
        tols = [TOL, TOL]
    else:
        dec = Decoder(d, hidden, 10, c_dim, folds=folds, generator=gen,
                      device=cuda)
        pairs = [*dec.hidden_layers(), dec.mean.pair()]
        flat = [t for p in pairs for t in p]
        pairs64 = [tuple(t.double() for t in p) for p in pairs]
        if op == "fused_pred_deviation":
            args = (z, c, x, flat, True)
            want = kernels.pred_deviation_reference(
                pairs64[:-1], pairs64[-1], z.double(), c.double(),
                x.double(), True)
            tols = [TOL, dict(rtol=1e-4, atol=1e-6)]
        else:
            args = (z, c, flat, True)
            want = (kernels.decode_mean_reference(
                pairs64[:-1], pairs64[-1], z.double(), c.double(), True),)
            tols = [TOL]
    counter = getattr(kernels, op)
    with torch.no_grad():
        before = counter.launches
        got = getattr(torch.ops.mmnm, op)(*args)
        assert counter.launches == before + 1
    got = got if isinstance(got, tuple) else (got,)
    for g, w, tol in zip(got, want, tols):
        assert g.device.type == "cuda"
        torch.testing.assert_close(g.double(), w, **tol)


def test_exported_cuda_program_matches_the_service(cuda, scoring_project,
                                                   tmp_path):
    """cli/export.py --platforms cpu,cuda on the card: the cuda programs
    hold the mmnm nodes, launch K1 and K2 once per modality a call (K1
    once more per modality for the latent) and equal ScoringService on
    the card at rtol 1e-6; the cpu programs within rtol 1e-4 / atol
    1e-5."""
    from multi_modal_normative_modeling_tpu_torch.cli import export, serve

    out = tmp_path / "model.mmnm"
    meta = export.run(["-R", "ADNI", "-P", "UCA-gPoE", "-K", "2", "-o",
                       str(out)], project_root=scoring_project)
    assert meta["platforms"] == ["cpu", "cuda"]
    card = export.load_scorer(out)
    cpu = export.load_scorer(out, device="cpu")
    for kind, k1, k2 in (("scoring", 4, 4), ("latent", 4, 0)):
        targets = [str(n.target) for n in card.programs[kind].graph.nodes]
        assert targets.count("mmnm.fused_encoder.default") == k1
        assert targets.count("mmnm.fused_pred_deviation.default") == k2
    service = serve.ScoringService("ADNI", "UCA-gPoE", n_splits=2,
                                   project_root=scoring_project,
                                   device="cuda")
    ids = list(service._frames[0].index)
    for n in (1, 64, 70):
        rows = [f.loc[ids[:n]] for f in service._frames]
        features = {name: r[cols].to_numpy(np.float32) for name, r, cols
                    in zip(service.dataset_names, rows, service.columns)}
        covariates = {"AGE": rows[-1]["AGE"].tolist(),
                      "PTGENDER": rows[-1]["PTGENDER"].tolist()}
        want = service.score_raw(features, covariates, roi=True, latent=True)
        kernels.reset_launch_counts()
        card.score(features, covariates, roi=True)
        assert kernels.fused_encoder.launches == 4
        assert kernels.fused_pred_deviation.launches == 4
        kernels.reset_launch_counts()
        got = card.score(features, covariates, roi=True, latent=True)
        assert kernels.fused_encoder.launches == 8
        assert kernels.fused_pred_deviation.launches == 4
        on_cpu = cpu.score(features, covariates, roi=True, latent=True)
        for key in ("deviation", "roi", "latent_deviation",
                    "latent_per_dim"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                       atol=0, err_msg=key)
            np.testing.assert_allclose(on_cpu[key], want[key], rtol=1e-4,
                                       atol=1e-5, err_msg=key)


# the packed layouts (train/packed.py and its siblings): case -> (model
# factory, trainer factory, batch extras, shuffle)
def _packed_cases():
    from multi_modal_normative_modeling_tpu_torch.models import (
        EndToEndCVAE,
        RegressionCVAE,
    )
    from multi_modal_normative_modeling_tpu_torch.train.grouped import (
        select_packed_trainer,
    )
    from multi_modal_normative_modeling_tpu_torch.train.packed_endtoend import (
        GroupedEndToEndTrainer,
    )
    from multi_modal_normative_modeling_tpu_torch.train.packed_regression import (
        GroupedRegressionTrainer,
    )

    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    mixed, uniform = [90, 90, 90, 270], [90, 90, 90]
    routed = lambda m, cfg: select_packed_trainer(m)[0](m, cfg, 40)  # noqa
    return {
        "padded-mvtcae": (lambda: build_model(
            "mvtCAE", uniform, [110, 110], 10, 29, 3, folds=2,
            generator=gen()), routed, None, False),
        "grouped-cvae": (lambda: build_model(
            "cVAE_multimodal", mixed, [110, 110], 10, 29, 4, folds=2,
            generator=gen()), routed, None, False),
        "dmvae": (lambda: build_model(
            "DMVAE", uniform, [110, 110], 40, 29, 3, folds=2,
            generator=gen()), routed, None, False),
        "endtoend": (lambda: EndToEndCVAE(
            uniform, [110, 110], 10, 29, 3, classifier_layers=(32, 16),
            folds=2, generator=gen()),
            lambda m, cfg: GroupedEndToEndTrainer(m, cfg, 40, 1.0, 0.1),
            "labels", False),
        "regression": (lambda: RegressionCVAE(
            mixed, [110, 110], 10, 2, 4, folds=2, generator=gen()),
            lambda m, cfg: GroupedRegressionTrainer(m, cfg, 40), "fi", True),
    }


PACKED_CASES = ["padded-mvtcae", "grouped-cvae", "dmvae", "endtoend",
                "regression", "grouped-cvae-bf16"]


@pytest.mark.parametrize("case", PACKED_CASES)
def test_packed_trainer_on_the_card_matches_the_cpu(cuda, case):
    """Three epochs of a packed layout's trainer on CUDA tensors against
    the same run on the CPU, on the same replayed noise (and keep masks,
    and permutations): logs rtol 1e-4 (2e-2 in bf16), parameters rtol
    5e-3 / atol 5e-5."""
    from multi_modal_normative_modeling_tpu_torch.interop import (
        params_to_jax,
    )
    from multi_modal_normative_modeling_tpu_torch.parallel import (
        stack_fold_batches,
    )
    from multi_modal_normative_modeling_tpu_torch.train import TrainConfig

    bf16 = case.endswith("-bf16")
    new_model, new_trainer, extra, shuffle = _packed_cases()[
        case.replace("-bf16", "")]
    rng = np.random.default_rng(11)
    model = new_model()
    c_dim = 2 if extra == "fi" else 29
    data, cov, extras = [], [], []
    for n in (40, 23):
        data.append([rng.standard_normal((n, d), dtype=np.float32)
                     for d in model.input_dim_list])
        cov.append([rng.standard_normal((n, c_dim), dtype=np.float32)]
                   * model.modalities)
        extras.append({extra: rng.integers(0, 2, (n, 1)).astype(np.float32)}
                      if extra else {})
    batches = stack_fold_batches(data, cov, 16,
                                 extras=extras if extra else None)
    epochs, nb = 3, batches["mask"].shape[1]
    draws = {"eps": rng.standard_normal((epochs * nb, 2, 16,
                                         model.noise_dim), dtype=np.float32)}
    if extra == "labels":
        draws["keeps"] = [rng.random((epochs * nb, 2, 16, w)) < 0.5
                          for w in model.keep_widths]
    if shuffle:
        draws["perms"] = np.stack([np.stack([
            np.concatenate([rng.permutation(own), np.arange(own, nb * 16)])
            for own in (48, 32)]) for _ in range(epochs)])
    config = TrainConfig(epochs=epochs, batch_size=16, combine="gpoe",
                         shuffle=shuffle,
                         precision="bf16" if bf16 else "fp32")
    runs = []
    for device in ("cpu", cuda):
        model = new_model().to(device)
        logs = new_trainer(model, config).run(batches, **draws)
        runs.append((logs, params_to_jax(model)))
    (cpu_logs, cpu_params), (gpu_logs, gpu_params) = runs
    for k in cpu_logs:
        np.testing.assert_allclose(gpu_logs[k], cpu_logs[k],
                                   rtol=2e-2 if bf16 else 1e-4, err_msg=k)
    for (path, a), (_, b) in zip(_tree_leaves(gpu_params),
                                 _tree_leaves(cpu_params)):
        if extra == "labels" and _sign_noise_leaf(path):
            continue
        np.testing.assert_allclose(a, b, rtol=5e-3 if not bf16 else 5e-2,
                                   atol=5e-5 if not bf16 else 5e-3,
                                   err_msg=path)


def _tree_leaves(tree, path="") -> list:
    """(path, leaf) of a JAX-layout tree of numpy arrays, in key order (the
    card has no jax to walk it)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _tree_leaves(tree[k], f"{path}['{k}']")]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, v in enumerate(tree)
                for leaf in _tree_leaves(v, f"{path}[{i}]")]
    return [(path, tree)]


def _sign_noise_leaf(path: str) -> bool:
    """The end-to-end classifier's leaves whose gradient is a rounded zero
    (a block's linear bias before BatchNorm, and the running mean carrying
    it): two float orders part there (tests/test_torch_endtoend.py)."""
    return (("'blocks'" in path and path.endswith("['linear']['b']"))
            or (path.startswith("['bn_state']") and path.endswith("['mean']")))


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "k4"])
def test_streamed_run_is_bit_equal_to_the_resident_run(cuda, fused):
    """S = NB (a shard a step, the most uploads): the streamed trainer's
    logs and parameters equal the resident one's, the uploads on a side
    stream, K4 launched a pair per modality and step."""
    from multi_modal_normative_modeling_tpu_torch.kernels.decoder_nll import (
        fused_decoder_loss_fn,
    )
    from multi_modal_normative_modeling_tpu_torch.parallel import (
        MultiFoldTrainer,
        stack_fold_batches,
    )
    from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
    from multi_modal_normative_modeling_tpu_torch.train.streaming import (
        StreamingFoldTrainer,
    )

    dims, rows = [90, 270], (70, 37)
    rng = np.random.default_rng(14)
    data = [[rng.standard_normal((n, d), dtype=np.float32) for d in dims]
            for n in rows]
    cov = [[rng.standard_normal((n, 29), dtype=np.float32)] * 2 for n in rows]
    batches = stack_fold_batches(data, cov, 16)
    nb = batches["mask"].shape[1]
    runs = []
    for shards in (None, nb):
        model = build_model("cVAE_multimodal", dims, [110, 110], 10, 29, 2,
                            folds=2, generator=torch.Generator().manual_seed(7),
                            device=cuda)
        config = TrainConfig(epochs=3, batch_size=16, combine="gpoe")
        loss = fused_decoder_loss_fn(model, config) if fused else None
        trainer = (MultiFoldTrainer(model, config, 70, loss_fn=loss)
                   if shards is None else
                   StreamingFoldTrainer(model, config, 70, shards=shards,
                                        loss_fn=loss))
        kernels.reset_launch_counts()
        logs = trainer.run(batches)
        torch.cuda.synchronize()
        runs.append((model, logs, kernels.decoder_nll.launches))
    (a, logs_a, _), (b, logs_b, launched) = runs
    for k in logs_a:
        np.testing.assert_array_equal(logs_a[k], logs_b[k], err_msg=k)
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    assert launched == (2 * len(dims) * 3 * nb if fused else 0)


def test_doctor_exits_0_on_the_card(cuda, capsys):
    import json

    from multi_modal_normative_modeling_tpu_torch.cli import doctor

    rc = doctor.run(["--json"])
    results = json.loads(capsys.readouterr().out)
    assert rc == 0, results
    assert all(r["status"] == "OK" for r in results), results
    build = [r["detail"] for r in results if r["section"] == "kernel-build"]
    assert "sm_90a" in build[0] and "release" in build[0]


@pytest.mark.parametrize("part", ["rows", "folds"])
def test_kernels_on_a_ranks_shard_match_plain(cuda, part):
    """K1 and K2 on what one rank of a --mesh test stage holds: a row slice
    ('data') or a fold slice ('fold') of a stacked [F, R, D] batch, made
    contiguous, against the plain version on the same slice."""
    dims, folds, rows = [90, 270], 4, 128
    rng = np.random.default_rng(15)
    xes = [_rows(rng, folds, rows, d).to(cuda) for d in dims]
    c = _rows(rng, folds, rows, 29).to(cuda)
    eps = _rows(rng, folds, rows, 10).to(cuda)
    f, r = ((slice(0, folds), slice(rows // 2, rows)) if part == "rows"
            else (slice(folds // 2, folds), slice(0, rows)))

    def cut(t):
        return t[f, r].contiguous()

    model = build_model("cVAE_multimodal", dims, [110, 110], 10, 29, 2,
                        folds=f.stop - f.start,
                        generator=torch.Generator().manual_seed(2),
                        device=cuda)
    shard = [cut(x) for x in xes]
    kernels.reset_launch_counts()
    recons, devs = model.pred_recon_fused(shard, [cut(c)] * 2, "gpoe",
                                          eps=cut(eps))
    assert kernels.fused_encoder.launches == 2
    assert kernels.fused_pred_deviation.launches == 2
    with torch.no_grad():
        ref = model.pred_recon(shard, [cut(c)] * 2, "gpoe", eps=cut(eps))
    for m in range(2):
        torch.testing.assert_close(recons[m], ref[m], rtol=2e-4, atol=2e-5)
        torch.testing.assert_close(
            devs[m], model.reconstruction_deviation(shard[m], ref[m]),
            rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("variant,combine", [("cVAE_multimodal", "gpoe"),
                                             ("cVAE_multimodal", "poe"),
                                             ("mmJSD", "poe")])
def test_a_folds_step_does_not_depend_on_the_folds_stacked(cuda, variant,
                                                           combine):
    """One step of the plain loss at F=10 and at its first five folds
    alone, the same per-fold operands: every gradient of folds 0-4 bit for
    bit (a fold's products and row sums take no split from F:
    ops/linear.fold_expand). Before, the N = 10 heads' bias gradients
    differed in the last bits and 200 epochs of the ADHD grid's cohort
    drifted 0.012 apart (scripts/torch_fold_stack_probe.py)."""
    from multi_modal_normative_modeling_tpu_torch.parallel import (
        stack_fold_batches,
    )
    from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
    from multi_modal_normative_modeling_tpu_torch.train.trainer import (
        DeviceBatches,
        resolve_loss,
    )

    rng = np.random.default_rng(16)
    dims = [116, 116]
    data = [[rng.standard_normal((300, d)).astype(np.float32) for d in dims]
            for _ in range(10)]
    cov = [[rng.standard_normal((300, 29)).astype(np.float32)] * 2
           for _ in range(10)]
    eps = torch.from_numpy(rng.standard_normal((10, 256, 10),
                                               dtype=np.float32))
    config = TrainConfig(epochs=1, batch_size=256, combine=combine)
    grads = {}
    for n in (10, 5):
        model = build_model(variant, dims, [110, 110], 10, 29, 2, folds=1,
                            generator=torch.Generator().manual_seed(0))
        stacked = build_model(variant, dims, [110, 110], 10, 29, 2, folds=n)
        with torch.no_grad():
            for p, q in zip(stacked.parameters(), model.parameters()):
                p.copy_(q.expand_as(p))
        stacked.to(cuda)
        batch = DeviceBatches(stack_fold_batches(data[:n], cov[:n], 256),
                              cuda).step(0)
        loss_fn, _ = resolve_loss(stacked, config, None)
        total, _ = loss_fn(batch, eps[:n].to(cuda))
        names = [k for k, _ in stacked.named_parameters()]
        grads[n] = dict(zip(names, torch.autograd.grad(
            total.sum(), list(stacked.parameters()), allow_unused=True)))
    for k, g in grads[5].items():
        assert (g is None) == (grads[10][k] is None), k
        assert g is None or torch.equal(grads[10][k][:5], g), k


def test_ep_scoring_on_one_rank_matches_the_fused_call(cuda):
    """parallel.modality.ep_pred_recon_fused on a one-rank modality axis
    (every modality owned): K1 and K2 once per modality, the same
    reconstructions as pred_recon_fused."""
    from multi_modal_normative_modeling_tpu_torch.parallel.mesh import Mesh
    from multi_modal_normative_modeling_tpu_torch.parallel.modality import (
        ep_pred_recon_fused,
    )

    dims, folds, rows = [90, 90, 90, 270], 5, 64
    rng = np.random.default_rng(17)
    xes = [_rows(rng, folds, rows, d).to(cuda) for d in dims]
    c = _rows(rng, folds, rows, 29).to(cuda)
    eps = _rows(rng, folds, rows, 10).to(cuda)
    model = build_model("cVAE_multimodal", dims, [110, 110], 10, 29, 4,
                        folds=folds, generator=torch.Generator().manual_seed(3),
                        device=cuda)
    mesh = Mesh({"fold": 1, "modality": 1, "data": 1}, 0, cuda)
    kernels.reset_launch_counts()
    out = ep_pred_recon_fused(model, [0, 1, 2, 3], dict(enumerate(xes)),
                              dict.fromkeys(range(4), c), "gpoe", eps, mesh)
    assert kernels.fused_encoder.launches == 4
    assert kernels.fused_pred_deviation.launches == 4
    recons, devs = model.pred_recon_fused(xes, [c] * 4, "gpoe", eps=eps)
    for m in range(4):
        torch.testing.assert_close(out[m][0], recons[m], rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(out[m][1], devs[m], rtol=1e-4, atol=1e-5)


# ---- MaskedAdam (K7): kernels/masked_adam.py against the plain expression --

# a fold invalid on its first step, all valid, every other fold, one fold
# out, none valid (nothing moves), all valid
ADAM_VALID = [[0, 1, 1, 1, 1, 1, 1, 1, 1, 0], [1] * 10,
              [1, 0, 1, 0, 1, 0, 1, 0, 1, 0], [1, 1, 1, 0, 1, 1, 1, 1, 1, 1],
              [0] * 10, [1] * 10]


def _adam_sizes(layout):
    """Parameter sizes of a MaskedAdam buffer at F = 10: the fused step's
    padded layout at a cell's widths, or runs that leave the buffer's
    length and most run starts off a multiple of 4."""
    from multi_modal_normative_modeling_tpu_torch.kernels.train_step import (
        FusedTrainStep,
    )
    from multi_modal_normative_modeling_tpu_torch.models.stacked import (
        StackedMultimodalCVAE,
    )

    if layout == "odd":
        return [10 * r for r in (7, 4099, 1, 8193, 3)]
    dims = {"adni": [90, 90, 90, 270], "ppmi": [3485] * 3}[layout]
    step = FusedTrainStep(StackedMultimodalCVAE(dims, [110, 110], 10, 29,
                                                len(dims)), "gpoe")
    return [10 * step._sizes[k] for k in step._param_names]


def _adam_lr(schedule, cuda, dtype):
    """count -> lr [F]: the constant and cyclic schedules, and the
    classifier's (its carry's lr, halved for some configurations after
    each step)."""
    from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
    from multi_modal_normative_modeling_tpu_torch.train.schedules import (
        cyclic_triangular,
    )
    from multi_modal_normative_modeling_tpu_torch.train.trainer import (
        build_lr_fn,
    )

    if schedule == "constant":
        return build_lr_fn(TrainConfig(), 512), None
    if schedule == "cyclic":
        return cyclic_triangular(1e-4, 5e-3, 4.0), None
    carry = {"lr": torch.linspace(1e-4, 1e-3, 10, device=cuda, dtype=dtype)}

    def decay(step):
        cut = torch.arange(10, device=cuda) % (step + 2) == 0
        carry["lr"] = torch.where(cut, carry["lr"] * 0.5, carry["lr"])

    return (lambda count: carry["lr"]), decay


def _adam_run(cuda, sizes, dtype, schedule, steps, seed=0):
    """The same steps through the kernel and through the plain expression,
    from the same start: (kernel's MaskedAdam, plain's, launches)."""
    from multi_modal_normative_modeling_tpu_torch.train.trainer import (
        MaskedAdam,
    )

    lr_fn, after = _adam_lr(schedule, cuda, dtype)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    params = [torch.randn(10, n // 10, generator=gen, device=cuda,
                          dtype=dtype) for n in sizes]
    fast = MaskedAdam([p.clone() for p in params], lr_fn)
    plain = MaskedAdam([p.clone() for p in params], lr_fn)
    before = kernels.masked_adam.launches
    for s in range(steps):
        g = torch.randn(sum(sizes), generator=gen, device=cuda, dtype=dtype)
        valid = torch.tensor(ADAM_VALID[s % len(ADAM_VALID)], device=cuda,
                             dtype=dtype)
        fast.step_flat(g, valid)
        plain.step_flat_plain(g, valid)
        if after is not None:
            after(s)
    return fast, plain, kernels.masked_adam.launches - before


def _adam_equal(a, b):
    for name in ("flat", "m", "v", "count"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        assert torch.equal(x, y), (name, int((x != y).sum()))


@pytest.mark.parametrize("schedule", ["constant", "cyclic", "classifier"])
@pytest.mark.parametrize("layout", ["adni", "ppmi", "odd"])
def test_masked_adam_kernel_is_bit_equal_to_plain(cuda, layout, schedule):
    """Six steps of each mask of ADAM_VALID at both cells' padded layouts
    (F = 10) and at a length that is not a multiple of 4: flat, m, v and
    count bit-equal to the plain expression, one launch a step."""
    sizes = _adam_sizes(layout)
    fast, plain, launches = _adam_run(cuda, sizes, torch.float32, schedule,
                                      len(ADAM_VALID))
    assert launches == len(ADAM_VALID)
    assert fast.flat.numel() == sum(sizes)
    _adam_equal(fast, plain)
    assert fast.count.tolist() == [float(sum(v)) for v in zip(*ADAM_VALID)]


def test_masked_adam_kernel_float64(cuda):
    """The kernel's double instantiation (a classifier whose model is fp64)
    against the plain expression in fp64."""
    fast, plain, launches = _adam_run(cuda, _adam_sizes("odd"),
                                      torch.float64, "classifier", 6)
    assert launches == 6
    _adam_equal(fast, plain)


def test_masked_adam_kernel_over_many_counts(cuda):
    """Both bias corrections at every count from 0 to 199 999 (one fold a
    count, one element a fold): torch.pow(b, count) on the card, bit for
    bit."""
    from multi_modal_normative_modeling_tpu_torch.train.trainer import (
        MaskedAdam,
    )

    folds = 200_000
    gen = torch.Generator(device=cuda).manual_seed(5)
    param = torch.randn(folds, 3, generator=gen, device=cuda)
    adams = [MaskedAdam([param.clone()], lambda count: torch.full_like(
        count, 1e-3)) for _ in range(2)]
    for adam in adams:
        adam.count = torch.arange(folds, device=cuda, dtype=torch.float32)
    g = torch.randn(3 * folds, generator=gen, device=cuda)
    valid = torch.ones(folds, device=cuda)
    adams[0].step_flat(g, valid)
    adams[1].step_flat_plain(g, valid)
    _adam_equal(*adams)


def test_masked_adam_resume_on_the_card(cuda):
    """Stopped after 3 steps at ADNI's layout, its state saved to the host
    and copied into a fresh optimizer (as TrainSession.restore does), then
    5 more steps: the uninterrupted run's bytes."""
    from multi_modal_normative_modeling_tpu_torch.train.trainer import (
        MaskedAdam,
    )

    sizes = _adam_sizes("adni")
    lr_fn, _ = _adam_lr("constant", cuda, torch.float32)
    gen = torch.Generator(device=cuda).manual_seed(11)
    params = [torch.randn(10, n // 10, generator=gen, device=cuda)
              for n in sizes]
    grads = [torch.randn(sum(sizes), generator=gen, device=cuda)
             for _ in range(8)]
    valids = [torch.tensor(ADAM_VALID[s % len(ADAM_VALID)], device=cuda,
                           dtype=torch.float32) for s in range(8)]
    straight = MaskedAdam([p.clone() for p in params], lr_fn)
    for g, valid in zip(grads, valids):
        straight.step_flat(g, valid)
    first = MaskedAdam([p.clone() for p in params], lr_fn)
    for g, valid in zip(grads[:3], valids[:3]):
        first.step_flat(g, valid)
    saved = {k: getattr(first, k).cpu().numpy() for k in
             ("flat", "m", "v", "count")}
    resumed = MaskedAdam([torch.zeros_like(p) for p in params], lr_fn)
    for k in ("flat", "m", "v"):
        getattr(resumed, k).copy_(torch.from_numpy(saved[k].copy()))
    count = torch.empty_like(resumed.count)
    count.copy_(torch.from_numpy(saved["count"].copy()))
    resumed.count = count
    for g, valid in zip(grads[3:], valids[3:]):
        resumed.step_flat(g, valid)
    _adam_equal(resumed, straight)


def test_masked_adam_refuses_what_the_kernel_does_not_take(cuda):
    """On the card nothing falls back to the plain expression: a bf16
    buffer is refused when the optimizer is built, a per-fold value on the
    host or of another length at a step."""
    from multi_modal_normative_modeling_tpu_torch.train.trainer import (
        MaskedAdam,
    )

    param = torch.zeros(2, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="masked_adam: buffer dtype"):
        MaskedAdam([param], lambda count: torch.full_like(count, 1e-3))
    adam = MaskedAdam([torch.zeros(2, 8, device=cuda)],
                      lambda count: torch.full_like(count, 1e-3))
    g = torch.ones(16, device=cuda)
    # a step uploads nothing: a per-fold value on the host is refused
    with pytest.raises(ValueError, match="masked_adam: valid"):
        adam.step_flat(g, torch.ones(2))
    with pytest.raises(ValueError, match="masked_adam: valid"):
        adam.step_flat(g, torch.ones(3, device=cuda))


def test_masked_adam_float64_takes_the_batches_fp32_valid(cuda):
    """The trainers' batches hold valid in fp32: an fp64 buffer takes it,
    cast on the card, to the plain expression's bytes."""
    from multi_modal_normative_modeling_tpu_torch.train.trainer import (
        MaskedAdam,
    )

    gen = torch.Generator(device=cuda).manual_seed(13)
    param = torch.randn(10, 7, generator=gen, device=cuda,
                        dtype=torch.float64)
    lr_fn, _ = _adam_lr("constant", cuda, torch.float64)
    fast = MaskedAdam([param.clone()], lr_fn)
    plain = MaskedAdam([param.clone()], lr_fn)
    for s in range(4):
        g = torch.randn(70, generator=gen, device=cuda, dtype=torch.float64)
        valid = torch.tensor(ADAM_VALID[s], device=cuda, dtype=torch.float32)
        fast.step_flat(g, valid)
        plain.step_flat_plain(g, valid)
    _adam_equal(fast, plain)


def test_masked_adam_is_built_without_waiting_for_the_card(cuda):
    """Building the optimizer on the card (once a job in the fused
    trainer's session) queues its uploads behind the stream's work and
    does not wait for it."""
    from multi_modal_normative_modeling_tpu_torch.train.trainer import (
        MaskedAdam,
    )

    sizes = _adam_sizes("adni")
    lr_fn, _ = _adam_lr("constant", cuda, torch.float32)
    params = [torch.zeros(10, n // 10, device=cuda) for n in sizes]
    MaskedAdam([p.clone() for p in params], lr_fn)
    clones = [p.clone() for p in params]
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream()
    torch.cuda._sleep(1 << 30)      # about half a second of the card's time
    adam = MaskedAdam(clones, lr_fn)
    busy = not stream.query()
    torch.cuda.synchronize()
    assert busy
    assert adam.plan.runs[-1][0] + 10 * adam.plan.runs[-1][1] == sum(sizes)
