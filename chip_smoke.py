#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root

Phases (any failure exits non-zero, with no result line):
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from kernels/csrc/ with nvcc (sm_90a);
  3. hold the encoder, decode+deviation and decoder-mean kernels against
     their plain torch versions on the card (TF32 off) at the test stage's
     shapes (one of them takes the decode kernel's column groups with a
     ragged last row tile), check that two calls give a bit-equal
     deviation, and time both;
  3b. hold the decoder_nll kernel pair (forward and backward) against its
     plain version plus autograd, with ragged row masks, at training
     shapes; check that two backward calls are bit-equal; time both, the
     forward and the pair;
  4. score 5 folds of the flagship model (cVAE_multimodal, UCA-gPoE widths
     4x[90, 90, 90, 270], c 29, hidden [110, 110], latent 10, 1024 padded
     rows per fold, seeded random weights) through the test stage's scoring
     entry, count the kernel launches of that one call, compare it with the
     plain path on the same eps, and time both; then the reconstruction
     call (encoder and decoder-mean kernels) the same way;
  5. train the flagship model (5 folds of 512 seeded subjects, one fold's
     last batch ragged, batch 256, 10 epochs) through MultiFoldTrainer with
     the --fused_decoder loss, count the decoder_nll launches of that run,
     and hold it against the plain loss from the same init and eps; then a
     few steps at PPMI width (3 x 3485, one fold) the same way; ms per step
     of both;
  6a. hold the fused train step (K5) against its plain version (autograd
     over the packed model, TF32 off) with ragged row masks: the flagship
     (5 folds), every fusion and 1 and 3 hidden layers at small width, two
     shapes none of whose widths is a multiple of 4 (so every tensor of
     the padded layout is wider than its true shape), and PPMI width with
     one fold; two calls bit-equal; the flat gradient buffer bit-equal to
     the gradients autograd takes through StepFunction; time both;
  6b. the batch-tiled step (K6) in fp32 with tile_b < B against K5 and the
     plain version, and in bf16 against the fp32 plain version (at the JAX
     test's shape) and against its own plain bf16 transcription (flagship,
     and a ragged-width shape whose batch is not a multiple of the tile);
     two calls bit-equal; time both;
  7. train the flagship (5 folds, 10 epochs) through FusedFoldTrainer (K5)
     and hold it against MultiFoldTrainer with the plain loss from the same
     init and eps, counting K5 launches; the same at PPMI width; then a few
     bf16 steps through K6 against the fp32 run; ms per step of both paths.

Beside every kernel time stands the kernel's bound: the least time the
card could take for the same work (kernels/roofline.py: the larger of its
FLOP over the card's peak for the operand type and its bytes over the
memory rate), and the share of it that the time reaches. A kernel's time is
given twice: by CUDA events around calls of its wrapper, host work
included, and as the time the device needs for the same launches replayed
from a CUDA graph, the host out of the way (`device_ms`).

The last line is {"ok": true, "device": {"platform": "gpu", ...}}; the line
before it holds the kernels' launches, errors, times and bounds.
"""
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

DIMS = [90, 90, 90, 270]
C_DIM = 29
HIDDEN = [110, 110]
LATENT = 10
FOLDS = 5
ROWS = 1024
COMBINE = "gpoe"

# (folds, rows, feature width, covariate width); the last two are the
# flagship scoring call's own shapes; at 3485 the decode kernel splits the
# mean head's columns over blocks, with 1000 rows over a ragged last tile
SHAPES = [(1, 7, 90, 29), (1, 1000, 3485, 2), (1, 1024, 3485, 2),
          (FOLDS, ROWS, 90, C_DIM), (FOLDS, ROWS, 270, C_DIM)]
TOL = dict(rtol=1e-5, atol=1e-5)       # mu, logvar, recon
DEV_TOL = dict(rtol=1e-4, atol=1e-6)   # per-row deviation
MODEL_TOL = dict(rtol=2e-4, atol=2e-5)  # whole scoring call

# decoder_nll (folds, rows, hidden, D), each with a ragged row mask; the
# bounds are tests/test_decoder_nll.py's: the value rtol 1e-5, gradients
# rtol 1e-4 / atol 1e-6 at flagship width, rtol 1e-3 / atol 1e-5 at 3485
NLL_SHAPES = [(1, 7, 110, 90), (5, 256, 110, 270), (1, 256, 110, 3485),
              (5, 256, 110, 3485)]
NLL_TIMED = (5, 256, 110, 270)  # the flagship step's widest modality
NLL_PPMI = (1, 256, 110, 3485)  # one PPMI modality of a one-fold step
NLL_VALUE_TOL = dict(rtol=1e-5, atol=0.0)
NLL_GRAD_TOL = {90: dict(rtol=1e-4, atol=1e-6), 270: dict(rtol=1e-4, atol=1e-6),
                3485: dict(rtol=1e-3, atol=1e-5)}

# training (bench.py:29-36): 512 subjects per fold, the last fold 500 so its
# second batch is ragged; and the PPMI width (bench.py:45-46)
TRAIN_ROWS = [512, 512, 512, 512, 500]
TRAIN_EPOCHS = 10
BATCH = 256
PPMI_DIMS = [3485, 3485, 3485]
RAGGED_DIMS = [37, 90, 271]
PPMI_ROWS = [2500]
LOG_TOL = dict(rtol=1e-4, atol=0.0)
PARAM_TOL = dict(rtol=5e-3, atol=1e-5)

# fused train step (tests/test_train_step_kernel.py:68-83,
# tests/test_train_step_tiled.py:71, :91-105, :126-146): losses rtol 1e-5,
# gradients rtol 1e-3 / atol 1e-5 (rtol 2e-3 / atol 2e-5 at 3485), K6 fp32
# against K5 rtol 1e-4 / atol 1e-6; bf16 against fp32 a total within 2e-2
# and a normalized error per gradient leaf under 6e-2, and the bf16 kernel
# against its own plain bf16 transcription (same cast points) a normalized
# error under 5e-3: a value that lands near a bf16 rounding boundary may
# round the other way from another summation order (one bf16 ulp, 2^-8),
# so the two agree to well under bf16's own error but not to fp32's;
# trajectories (tests/test_fused_cli.py:57-62) logs rtol 2e-4, parameters
# rtol 5e-3 / atol 5e-5
STEP_LOSS_TOL = dict(rtol=1e-5, atol=0.0)
STEP_GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
STEP_GRAD_TOL_WIDE = dict(rtol=2e-3, atol=2e-5)
TILED_TOL = dict(rtol=1e-4, atol=1e-6)
BF16_TOTAL, BF16_LEAF, BF16_OWN = 2e-2, 6e-2, 5e-3
FUSED_LOG_TOL = dict(rtol=2e-4, atol=0.0)
FUSED_PARAM_TOL = dict(rtol=5e-3, atol=5e-5)
# (name, dims, hidden, folds, rows, C, Z, fusion)
STEP_SHAPES = [
    ("flagship", DIMS, HIDDEN, FOLDS, BATCH, C_DIM, LATENT, COMBINE),
    ("poe", [40, 60, 30], [32, 32], 2, 100, C_DIM, LATENT, "poe"),
    ("moe", [40, 60, 30], [32, 32], 2, 100, C_DIM, LATENT, "moe"),
    ("mopoe", [40, 60, 30], [32, 32], 2, 100, C_DIM, LATENT, "mopoe"),
    ("1 hidden", [40, 60, 30], [48], 2, 100, C_DIM, LATENT, "gpoe"),
    ("3 hidden", [40, 60, 30], [64, 110, 32], 2, 100, C_DIM, LATENT, "gpoe"),
    ("1 modality", [90], HIDDEN, 2, 100, C_DIM, LATENT, "gpoe"),
    # no width a multiple of 4: d_max, hidden, latent and covariates all
    # padded, with ragged rows
    ("ragged widths", RAGGED_DIMS, HIDDEN, 2, 100, C_DIM, LATENT, "gpoe"),
    ("ragged widths, C 2", RAGGED_DIMS, [110, 57], 2, 75, 2, 7, "poe"),
    ("PPMI", PPMI_DIMS, HIDDEN, 1, BATCH, C_DIM, LATENT, COMBINE),
]
FLAT_CHECKED = ("flagship", "ragged widths", "PPMI")
TILE = 64        # K6's tile in phase 6b: 4 row groups of the flagship batch
BF16_STEPS = 4   # phase 7's bf16 steps (2 epochs of the flagship cohort)


def cuda_ms(fn, iters=50, warmup=5):
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, replays=5):
    """Mean time in ms that the device needs for what one fn() launches,
    with the host out of the way: `iters` calls are captured into one CUDA
    graph, and CUDA events time replays of the graph. Between two kernels
    there is then the graph's own launch gap (a microsecond or two) and
    nothing of the wrapper's host work."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm up where the capture will run
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def wall_ms(fn, iters=20, warmup=3):
    """Mean host wall time of fn() in ms, each call synchronized."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound_text(work, ms):
    """'bound x ms by y, z% reached' for a roofline.Work and a time."""
    return (f"bound {work.bound_ms:.5f} ms by {work.bound_by} "
            f"({work.peak_name}), {100 * work.share(ms):.1f}% reached")


def step_work(dims, hidden, folds, rows, c_dim, z_dim, bf16=False):
    from multi_modal_normative_modeling_tpu_torch.kernels import roofline

    return roofline.fused_train_step(folds, rows, dims, c_dim, hidden, z_dim,
                                     bf16=bf16)


def check_close(what, got, want, tol):
    if got.shape != want.shape:
        raise RuntimeError(f"{what}: shape {tuple(got.shape)} != "
                           f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{what}: non-finite values")
    err = (got - want).abs()
    rel = (err / want.abs().clamp_min(1e-30)).max().item()
    if not torch.allclose(got, want, **tol):
        raise RuntimeError(f"{what}: max abs err {err.max().item():.3e}, "
                           f"max rel err {rel:.3e} over {tol}")
    return err.max().item(), rel


def one_hot_covariates(rng, rows):
    """One-hot age (27 bins) + gender (2 bins), as the CLIs feed."""
    c = np.zeros((rows, C_DIM), np.float32)
    idx = np.arange(rows)
    c[idx, rng.integers(0, 27, rows)] = 1.0
    c[idx, 27 + rng.integers(0, 2, rows)] = 1.0
    return c


def covariates(rng, folds, rows):
    return torch.from_numpy(np.stack([one_hot_covariates(rng, rows)
                                      for _ in range(folds)])).cuda()


def check_nll(rng, folds, rows, hidden, d):
    """decoder_nll's kernels against the plain version plus autograd on
    one ragged shape; returns (max abs err, max rel err, times in ms)."""
    from multi_modal_normative_modeling_tpu_torch.kernels.decoder_nll import (
        decoder_nll,
        decoder_nll_reference,
    )

    def normal(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).cuda()

    # g at a LeakyReLU activation's scale, w and b at the init's, and x
    # drawn from the decoder's own Gaussian N(g w^T + b, exp(lvo)): gradient
    # entries of order 1, where an absolute 1e-6 is a bound on the kernel's
    # arithmetic and not on fp32 rounding of large terms (with x ~ N(0, 1)
    # and lvo = -3 at n = 5 the dW terms reach ~50, and two summation orders
    # differ by 2.5 ulp of them, ~1e-5)
    g = normal(folds, rows, hidden, scale=0.5).requires_grad_()
    w = normal(folds, d, hidden, scale=0.05).requires_grad_()
    b = normal(folds, d, scale=0.1).requires_grad_()
    lvo = (normal(folds, 1, d, scale=0.1) - 1.0).requires_grad_()
    with torch.no_grad():
        x = (g @ w.mT + b[:, None] + torch.exp(0.5 * lvo)
             * normal(folds, rows, d))
    mask = torch.ones(folds, rows, device="cuda")
    for f in range(folds):
        mask[f, rows - 2 - f:] = 0.0  # ragged: n < B in every fold
    n = torch.clamp(mask.sum(-1), min=1.0)
    params = (g, w, b, lvo)

    def value_and_grads(fn):
        ll = fn(g, w, b, lvo, x, mask, n)
        return ll, torch.autograd.grad(ll.sum(), params)

    ll, grads = value_and_grads(decoder_nll)
    ll_p, grads_p = value_and_grads(decoder_nll_reference)
    errs = [check_close(f"decoder_nll value {folds}x{rows}x{d}", ll.detach(),
                        ll_p.detach(), NLL_VALUE_TOL)]
    for name, got, want in zip(("dg", "dw", "db", "dlvo"), grads, grads_p):
        errs.append(check_close(f"decoder_nll {name} {folds}x{rows}x{d}", got,
                                want, NLL_GRAD_TOL[d]))
    again = value_and_grads(decoder_nll)[1]
    for name, a, b2 in zip(("dg", "dw", "db", "dlvo"), grads, again):
        if not torch.equal(a, b2):
            raise RuntimeError(f"decoder_nll {name}: two backward calls "
                               "differ")
    times = {}
    with torch.no_grad():
        times["fwd"] = cuda_ms(lambda: decoder_nll(g, w, b, lvo, x, mask, n))
        times["plain_fwd"] = cuda_ms(
            lambda: decoder_nll_reference(g, w, b, lvo, x, mask, n))
    times["fwd_bwd"] = cuda_ms(lambda: value_and_grads(decoder_nll))
    times["plain_fwd_bwd"] = cuda_ms(
        lambda: value_and_grads(decoder_nll_reference))
    with torch.no_grad():
        times["fwd_device"] = device_ms(
            lambda: decoder_nll(g, w, b, lvo, x, mask, n))

    def fresh_pair(fn):
        # leaves made inside the capture: autograd ties a leaf to the
        # stream it was made on, and the outer ones belong to the default
        # stream, which a capture may not wait for
        leaves = [p.detach().requires_grad_() for p in params]
        return torch.autograd.grad(fn(*leaves, x, mask, n).sum(), leaves)

    times["fwd_bwd_device"] = device_ms(lambda: fresh_pair(decoder_nll))
    times["plain_fwd_bwd_device"] = device_ms(
        lambda: fresh_pair(decoder_nll_reference))
    return max(e for e, _ in errs), max(r for _, r in errs), times


def training_run(dims, rows_per_fold, epochs, seed, fused):
    """Fresh seeded model and cohort, trained by MultiFoldTrainer with the
    --fused_decoder loss or the plain loss on fixed eps; returns (logs,
    final state dict, ms per step, steps). The batches are uploaded before
    the clock starts."""
    from multi_modal_normative_modeling_tpu_torch.kernels.decoder_nll import (
        fused_decoder_loss_fn,
    )
    from multi_modal_normative_modeling_tpu_torch.models import build_model
    from multi_modal_normative_modeling_tpu_torch.parallel import (
        MultiFoldTrainer,
        stack_fold_batches,
    )
    from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
    from multi_modal_normative_modeling_tpu_torch.train.trainer import (
        DeviceBatches,
    )

    rng = np.random.default_rng(seed)
    folds = len(rows_per_fold)
    data = [[rng.standard_normal((n, d), dtype=np.float32) for d in dims]
            for n in rows_per_fold]
    cov = [[one_hot_covariates(rng, n)] * len(dims) for n in rows_per_fold]
    batches = DeviceBatches(stack_fold_batches(data, cov, BATCH), "cuda")
    steps = epochs * batches.n_batches
    eps = torch.randn((steps, folds, BATCH, LATENT),
                      generator=torch.Generator().manual_seed(seed)).cuda()
    model = build_model("cVAE_multimodal", dims, HIDDEN, LATENT, C_DIM,
                        len(dims), folds=folds,
                        generator=torch.Generator().manual_seed(seed),
                        device="cuda")
    config = TrainConfig(epochs=epochs, batch_size=BATCH, combine=COMBINE)
    loss = fused_decoder_loss_fn(model, config) if fused else None
    trainer = MultiFoldTrainer(model, config, max(rows_per_fold), loss_fn=loss)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs = trainer.run(batches, eps=eps)  # ends in a fetch: synchronized
    ms = (time.perf_counter() - t0) * 1e3 / steps
    for k, v in logs.items():
        if not np.isfinite(v).all() or v.shape != (folds, epochs):
            raise RuntimeError(f"training log {k}: shape {v.shape}, finite "
                               f"{np.isfinite(v).all()}")
    return logs, model.state_dict(), ms, steps


def compare_training(what, dims, rows_per_fold, epochs, seed):
    """plain, kernel, kernel, plain: holds the first kernel run against the
    first plain run and returns the kernel run's decoder_nll launches and
    the ms per step of each run."""
    from multi_modal_normative_modeling_tpu_torch import kernels

    logs_p, state_p, plain1, steps = training_run(dims, rows_per_fold,
                                                  epochs, seed, fused=False)
    kernels.reset_launch_counts()
    logs_k, state_k, kern1, _ = training_run(dims, rows_per_fold, epochs,
                                             seed, fused=True)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    want = 2 * len(dims) * steps  # a forward and a backward per modality
    if launches["decoder_nll"] != want:
        raise RuntimeError(f"{what}: decoder_nll launched "
                           f"{launches['decoder_nll']} times, expected {want}")
    for k in logs_p:
        check_close(f"{what} log {k}", torch.from_numpy(logs_k[k]),
                    torch.from_numpy(logs_p[k]), LOG_TOL)
    err = 0.0
    for k in state_p:
        err = max(err, check_close(f"{what} param {k}", state_k[k],
                                   state_p[k], PARAM_TOL)[0])
    kern2 = training_run(dims, rows_per_fold, epochs, seed, fused=True)[2]
    plain2 = training_run(dims, rows_per_fold, epochs, seed, fused=False)[2]
    print(f"phase 5: {what}: {len(rows_per_fold)} folds x {rows_per_fold} "
          f"subjects, widths {dims}, {steps} steps: launches {launches}; "
          f"final params max abs err {err:.3e}; ms/step kernel "
          f"{kern1:.4f}, {kern2:.4f}, plain {plain1:.4f}, {plain2:.4f}",
          flush=True)
    return launches


def step_problem(dims, hidden, folds, rows, c_dim, z_dim, seed):
    """A seeded packed model and one ragged batch on the card: (stacked,
    packed params, x [F, M, B, d_max], c [F, B, C], eps, row mask)."""
    from multi_modal_normative_modeling_tpu_torch.interop import (
        packed_from_model,
    )
    from multi_modal_normative_modeling_tpu_torch.models import build_model
    from multi_modal_normative_modeling_tpu_torch.models.stacked import (
        StackedMultimodalCVAE,
    )

    rng = np.random.default_rng(seed)
    model = build_model("cVAE_multimodal", dims, hidden, z_dim, c_dim,
                        len(dims), folds=folds,
                        generator=torch.Generator().manual_seed(seed),
                        device="cuda")
    stacked = StackedMultimodalCVAE(dims, hidden, z_dim, c_dim, len(dims))
    packed = packed_from_model(model, stacked)
    x = stacked.pack_inputs([rng.standard_normal((folds, rows, d),
                                                 dtype=np.float32)
                             for d in dims]).cuda()
    if c_dim == C_DIM:
        c = covariates(rng, folds, rows)
    else:
        c = torch.from_numpy(rng.standard_normal(
            (folds, rows, c_dim), dtype=np.float32)).cuda()
    eps = torch.from_numpy(rng.standard_normal(
        (folds, rows, z_dim), dtype=np.float32)).cuda()
    mask = torch.ones(folds, rows, device="cuda")
    for f in range(folds):
        mask[f, rows - 2 - f:] = 0.0   # ragged: n < B in every fold
    return stacked, packed, x, c, eps, mask


def leaf_error(got, want):
    """Normalized error of one gradient leaf: |got - want| / |want|."""
    return ((got.double() - want.double()).norm()
            / (want.double().norm() + 1e-12)).item()


def check_bit_equal(what, a, b):
    for k in a:
        if not torch.equal(a[k], b[k]):
            raise RuntimeError(f"{what} d{k}: two calls differ")


def fp64(*tensors):
    return [t.double() for t in tensors]


def plain64(reference, named, batch):
    """A plain version evaluated in fp64 on the same inputs (the plain code
    with double operands), rounded back to fp32: the reference the kernels
    are held to. The fp32 evaluation on the card (cuBLAS) strayed up to
    6.3e-3 from fp64 at the flagship in one call of this script, while the
    kernel stayed within 1.6e-6."""
    losses, grads = reference({k: v.double() for k, v in named.items()},
                              *fp64(*batch))
    return ({k: v.float() for k, v in losses.items()},
            {k: v.float() for k, v in grads.items()})


def check_step(name, dims, hidden, folds, rows, c_dim, z_dim, combine):
    """K5 against autograd over the packed model (in fp64) on one ragged
    batch; returns (max abs err, (kernel ms, fp32 plain ms))."""
    from multi_modal_normative_modeling_tpu_torch.kernels.train_step import (
        FusedTrainStep,
    )

    stacked, packed, x, c, eps, mask = step_problem(
        dims, hidden, folds, rows, c_dim, z_dim, seed=len(name) + rows)
    step = FusedTrainStep(stacked, combine)
    named = step.pad_params(packed)
    xx, cc, rm, nv = step.pack_batch(x, c, mask)
    batch = (xx, cc, eps, rm, nv)
    losses, grads = step.loss_and_grads_padded(named, *batch)
    ref_losses, ref_grads = plain64(step.reference, named, batch)
    plain_err = max((g - ref_grads[k]).abs().max().item() for k, g in
                    step.reference(named, *batch)[1].items())
    for k in losses:
        check_close(f"K5 {name} {k}", losses[k], ref_losses[k],
                    STEP_LOSS_TOL)
    tol = STEP_GRAD_TOL_WIDE if max(dims) > 1000 else STEP_GRAD_TOL
    err = max(check_close(f"K5 {name} d{k}", grads[k], ref_grads[k], tol)[0]
              for k in grads)
    check_bit_equal(f"K5 {name}", grads,
                    step.loss_and_grads_padded(named, *batch)[1])
    flat_note = ""
    if name in FLAT_CHECKED:
        # the trainer's path (the flat buffer) against autograd's
        flat = step.loss_and_grads_flat(named, *batch)[1]
        leaves = [torch.nn.Parameter(named[k].clone())
                  for k in step._param_names]
        total, _ = step.loss_fn(leaves)(
            {"x": xx, "c": cc, "rm": rm, "nvalid": nv}, eps)
        auto = torch.autograd.grad(total.sum(), leaves)
        if not torch.equal(flat, torch.cat([g.reshape(-1) for g in auto])):
            raise RuntimeError(f"K5 {name}: the flat gradient buffer differs "
                               "from StepFunction's gradients")
        flat_note = ", flat buffer bit-equal to StepFunction's gradients"
    from multi_modal_normative_modeling_tpu_torch.kernels import train_step
    plan = train_step.plan(step, folds, rows)
    # timed through the entry the trainer calls
    ms = cuda_ms(lambda: step.loss_and_grads_flat(named, *batch))
    plain = cuda_ms(lambda: step.reference(named, *batch))
    work = step_work(dims, hidden, folds, rows, c_dim, z_dim)
    print(f"phase 6a: K5 {name}: {folds} folds x {rows} rows, widths {dims}, "
          f"hidden {hidden}, {combine}, route {plan}: max abs err {err:.3e} "
          f"(the fp32 plain's {plain_err:.3e}), bit-equal{flat_note}; "
          f"{ms:.4f} ms vs plain forward+autograd {plain:.4f} ms; "
          f"{bound_text(work, ms)}", flush=True)
    device = (device_ms(lambda: step.loss_and_grads_flat(named, *batch))
              if name == "flagship" else None)   # the shape the report keeps
    return err, (ms, plain, work, device)


def check_tiled():
    """K6 in fp32 (tile < B) against K5 and the plain version; in bf16
    against the fp32 plain version at the JAX test's shape and against its
    own plain bf16 transcription at the flagship. Returns (max abs err of
    the fp32 checks, (bf16 kernel ms, its plain ms)) at the flagship."""
    from multi_modal_normative_modeling_tpu_torch.kernels.train_step import (
        FusedTrainStep,
    )
    from multi_modal_normative_modeling_tpu_torch.kernels.train_step_tiled import (  # noqa: E501
        TiledFusedTrainStep,
    )

    stacked, packed, x, c, eps, mask = step_problem(
        DIMS, HIDDEN, FOLDS, BATCH, C_DIM, LATENT, seed=11)
    k5 = FusedTrainStep(stacked, COMBINE)
    named = k5.pad_params(packed)
    xx, cc, rm, nv = k5.pack_batch(x, c, mask)
    batch = (xx, cc, eps, rm, nv)
    l5, g5 = k5.loss_and_grads_padded(named, *batch)
    ref_l, ref_g = plain64(k5.reference, named, batch)
    t32 = TiledFusedTrainStep(stacked, COMBINE, tile_b=TILE)
    lt, gt = t32.loss_and_grads_padded(named, *batch)
    check_close("K6 fp32 total vs K5", lt["total"], l5["total"],
                STEP_LOSS_TOL)
    err = 0.0
    for k in gt:
        check_close(f"K6 fp32 d{k} vs K5", gt[k], g5[k], TILED_TOL)
        err = max(err, check_close(f"K6 fp32 d{k} vs plain", gt[k],
                                   ref_g[k], STEP_GRAD_TOL)[0])
    check_bit_equal("K6 fp32", gt, t32.loss_and_grads_padded(named, *batch)[1])
    ms32 = cuda_ms(lambda: t32.loss_and_grads_flat(named, *batch))
    plain32 = cuda_ms(lambda: t32.reference(named, *batch))

    # bf16 against fp32 at the JAX test's shape (tests/test_train_step_
    # tiled.py:126-146: widths 24/40/16, hidden 12/12, latent 6, c 5, 20
    # rows, tile 16)
    s_st, s_packed, s_x, s_c, s_eps, s_mask = step_problem(
        [24, 40, 16], [12, 12], 1, 20, 5, 6, seed=4)
    small = TiledFusedTrainStep(s_st, "gpoe", tile_b=16,
                                compute_dtype=torch.bfloat16)
    s_named = small.pad_params(s_packed)
    sx, sc, srm, snv = small.pack_batch(s_x, s_c, s_mask)
    s_batch = (sx, sc, small.pad_eps(s_eps), srm, snv)
    lb, gb = small.loss_and_grads_padded(s_named, *s_batch)
    s32 = FusedTrainStep(s_st, "gpoe")     # fp32, in its own layout
    fx, fc, frm, fnv = s32.pack_batch(s_x, s_c, s_mask)
    lf, gf = plain64(s32.reference, s32.pad_params(s_packed),
                     (fx, fc, s_eps, frm, fnv))
    total_rel = ((lb["total"] - lf["total"]).abs()
                 / lf["total"].abs()).max().item()
    gb, gf = small.strip(gb), s32.strip(gf)
    leaf = max(leaf_error(gb[k], gf[k]) for k in gb)
    if not total_rel < BF16_TOTAL or not leaf < BF16_LEAF:
        raise RuntimeError(f"K6 bf16 vs fp32 plain: total rel {total_rel:.3e}"
                           f", worst leaf {leaf:.3e}")

    # bf16 at the flagship against its own plain bf16 transcription, in its
    # own layout (widths padded to 16, where fp32 pads to 4) and on the
    # batch stored in bf16, as the trainer keeps it
    t16 = TiledFusedTrainStep(stacked, COMBINE, tile_b=TILE,
                              compute_dtype=torch.bfloat16)
    named_w = t16.pad_params(packed)
    x16, c16, rm16, nv16 = t16.pack_batch(x, c, mask)
    stored = t16.cast_batch({"x": x16, "c": c16})
    b16 = (stored["x"], stored["c"], t16.pad_eps(eps), rm16, nv16)
    lb16, gb16 = t16.loss_and_grads_padded(named_w, *b16)
    named16 = t16.cast_exec(named_w)
    # the transcription with bf16 cast points, computed in fp64
    lp16, gp16 = plain64(t16.reference, named16, b16)
    own = max(leaf_error(gb16[k], gp16[k]) for k in gb16)
    own_total = ((lb16["total"] - lp16["total"]).abs()
                 / lp16["total"].abs()).max().item()
    true16, true_p16, true_ref = (t16.strip(gb16), t16.strip(gp16),
                                  k5.strip(ref_g))
    vs_fp32 = max(leaf_error(true16[k], true_ref[k]) for k in true16)
    plain_vs_fp32 = max(leaf_error(true_p16[k], true_ref[k])
                        for k in true_p16)
    if not own < BF16_OWN or not own_total < BF16_OWN:
        raise RuntimeError(f"K6 bf16 vs its plain bf16: worst leaf {own:.3e}"
                           f", total rel {own_total:.3e}")
    check_bit_equal("K6 bf16", gb16,
                    t16.loss_and_grads_padded(named_w, *b16)[1])
    ms16 = cuda_ms(lambda: t16.loss_and_grads_flat(named_w, *b16))
    plain16 = cuda_ms(lambda: t16.reference(named16, *b16))
    work16 = step_work(DIMS, HIDDEN, FOLDS, BATCH, C_DIM, LATENT, bf16=True)

    # ragged widths, 100 rows in tiles of 48 (padded to 144), both types
    ragged = {}
    r_st, r_packed, r_x, r_c, r_eps, r_mask = step_problem(
        RAGGED_DIMS, HIDDEN, 2, 100, C_DIM, LATENT, seed=13)
    for dtype in (torch.float32, torch.bfloat16):
        rt = TiledFusedTrainStep(r_st, COMBINE, tile_b=48,
                                 compute_dtype=dtype)
        r_named = rt.pad_params(r_packed)
        rx, rc, rrm, rnv = rt.pack_batch(r_x, r_c, r_mask)
        r_batch = (rx, rc, rt.pad_eps(r_eps), rrm, rnv)
        lr, gr = rt.loss_and_grads_padded(r_named, *r_batch)
        cast = (rt.cast_batch({"x": rx, "c": rc}))
        lp, gp = plain64(rt.reference, rt.cast_exec(r_named),
                         (cast["x"], cast["c"]) + r_batch[2:])
        ragged[dtype] = max(leaf_error(gr[k], gp[k]) for k in gr)
        rel = ((lr["total"] - lp["total"]).abs()
               / lp["total"].abs()).max().item()
        bound = BF16_OWN if dtype == torch.bfloat16 else 1e-4
        if not ragged[dtype] < bound or not rel < bound:
            raise RuntimeError(f"K6 {dtype} ragged widths: worst leaf "
                               f"{ragged[dtype]:.3e}, total rel {rel:.3e}")
        check_bit_equal(f"K6 {dtype} ragged", gr,
                        rt.loss_and_grads_padded(r_named, *r_batch)[1])
    print(f"phase 6b: K6 fp32 tile {TILE}: max abs err {err:.3e} vs plain, "
          f"within {TILED_TOL} of K5, bit-equal; {ms32:.4f} ms vs plain "
          f"{plain32:.4f} ms; "
          f"{bound_text(step_work(DIMS, HIDDEN, FOLDS, BATCH, C_DIM, LATENT), ms32)}"
          f". K6 bf16 at the JAX test's shape: total rel "
          f"{total_rel:.3e}, worst leaf {leaf:.3e} vs fp32 plain. K6 bf16 "
          f"flagship: worst leaf {own:.3e} vs its plain bf16 (whose own "
          f"worst leaf vs fp32 is {plain_vs_fp32:.3e}; the kernel's "
          f"{vs_fp32:.3e}), bit-equal; {ms16:.4f} ms vs plain {plain16:.4f} "
          f"ms; {bound_text(work16, ms16)}. K6 at ragged widths {RAGGED_DIMS}"
          f", 100 rows in tiles of 48: worst leaf vs its plain version "
          f"{ragged[torch.float32]:.3e} (fp32), "
          f"{ragged[torch.bfloat16]:.3e} (bf16), bit-equal", flush=True)
    device16 = device_ms(lambda: t16.loss_and_grads_flat(named_w, *b16))
    return err, (ms16, plain16, work16, device16)


def fused_training_run(dims, rows_per_fold, epochs, seed, fused,
                       precision="fp32"):
    """Fresh seeded model and cohort trained on fixed eps by
    MultiFoldTrainer with the plain loss or by FusedFoldTrainer (K5 in
    fp32, K6 in bf16); returns (logs, final packed params, ms per step,
    steps). The batches are uploaded before the clock starts."""
    from multi_modal_normative_modeling_tpu_torch.interop import (
        packed_from_model,
    )
    from multi_modal_normative_modeling_tpu_torch.models import build_model
    from multi_modal_normative_modeling_tpu_torch.models.stacked import (
        StackedMultimodalCVAE,
    )
    from multi_modal_normative_modeling_tpu_torch.parallel import (
        MultiFoldTrainer,
        stack_fold_batches,
    )
    from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
    from multi_modal_normative_modeling_tpu_torch.train.fused import (
        FusedFoldTrainer,
    )
    from multi_modal_normative_modeling_tpu_torch.train.trainer import (
        DeviceBatches,
    )

    rng = np.random.default_rng(seed)
    folds = len(rows_per_fold)
    data = [[rng.standard_normal((n, d), dtype=np.float32) for d in dims]
            for n in rows_per_fold]
    cov = [one_hot_covariates(rng, n) for n in rows_per_fold]
    model = build_model("cVAE_multimodal", dims, HIDDEN, LATENT, C_DIM,
                        len(dims), folds=folds,
                        generator=torch.Generator().manual_seed(seed),
                        device="cuda")
    config = TrainConfig(epochs=epochs, batch_size=BATCH, combine=COMBINE,
                         precision=precision)
    stacked = StackedMultimodalCVAE(dims, HIDDEN, LATENT, C_DIM, len(dims))
    if not fused:
        batches = DeviceBatches(stack_fold_batches(
            data, [[c] * len(dims) for c in cov], BATCH), "cuda")
        trainer = MultiFoldTrainer(model, config, max(rows_per_fold))
    else:
        trainer = FusedFoldTrainer(model, config, max(rows_per_fold))
        batches = trainer.batches(data, cov, "cuda")
        packed = packed_from_model(model, stacked)
    steps = epochs * batches.n_batches
    eps = torch.randn((steps, folds, BATCH, LATENT),
                      generator=torch.Generator().manual_seed(seed)).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if not fused:
        logs = trainer.run(batches, eps=eps)  # ends in a fetch
        trained = packed_from_model(model, stacked)
    else:
        trained, logs = trainer.run(packed, batches, eps=eps)
    ms = (time.perf_counter() - t0) * 1e3 / steps
    for k, v in logs.items():
        if not np.isfinite(v).all() or v.shape != (folds, epochs):
            raise RuntimeError(f"training log {k}: shape {v.shape}, finite "
                               f"{np.isfinite(v).all()}")
    return logs, trained, ms, steps


def packed_leaves(tree):
    """The tensors of a packed tree, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in packed_leaves(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in packed_leaves(v)]
    return [tree]


def compare_fused_training(what, dims, rows_per_fold, epochs, seed):
    """plain, K5, K5, plain: holds the first K5 run against the first plain
    run and returns the K5 run's launches."""
    from multi_modal_normative_modeling_tpu_torch import kernels

    logs_p, state_p, plain1, steps = fused_training_run(
        dims, rows_per_fold, epochs, seed, fused=False)
    kernels.reset_launch_counts()
    logs_k, state_k, kern1, _ = fused_training_run(
        dims, rows_per_fold, epochs, seed, fused=True)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    if launches["fused_train_step"] != steps:
        raise RuntimeError(f"{what}: fused_train_step launched "
                           f"{launches['fused_train_step']} times, expected "
                           f"{steps}")
    for k in logs_p:
        check_close(f"{what} fused log {k}", torch.from_numpy(logs_k[k]),
                    torch.from_numpy(logs_p[k]), FUSED_LOG_TOL)
    err = 0.0
    for a, b in zip(packed_leaves(state_k), packed_leaves(state_p)):
        err = max(err, check_close(f"{what} fused param", a, b,
                                   FUSED_PARAM_TOL)[0])
    kern2 = fused_training_run(dims, rows_per_fold, epochs, seed,
                               fused=True)[2]
    plain2 = fused_training_run(dims, rows_per_fold, epochs, seed,
                                fused=False)[2]
    print(f"phase 7: {what}: {len(rows_per_fold)} folds x {rows_per_fold} "
          f"subjects, widths {dims}, {steps} steps: launches {launches}; "
          f"final params max abs err {err:.3e}; ms/step K5 {kern1:.4f}, "
          f"{kern2:.4f}, plain {plain1:.4f}, {plain2:.4f}", flush=True)
    return launches


def bf16_training(seed):
    """A few flagship steps through K6 in bf16 against the same steps in
    fp32 (K5) from the same init and eps; returns the K6 run's launches."""
    from multi_modal_normative_modeling_tpu_torch import kernels

    epochs = BF16_STEPS // 2
    logs_f, state_f, ms_f, steps = fused_training_run(
        DIMS, TRAIN_ROWS, epochs, seed, fused=True)
    kernels.reset_launch_counts()
    logs_b, state_b, ms_b, _ = fused_training_run(
        DIMS, TRAIN_ROWS, epochs, seed, fused=True, precision="bf16")
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    if launches["tiled_fused_train_step"] != steps:
        raise RuntimeError(f"bf16: tiled_fused_train_step launched "
                           f"{launches['tiled_fused_train_step']} times, "
                           f"expected {steps}")
    total_rel = np.max(np.abs(logs_b["total"] - logs_f["total"])
                       / np.abs(logs_f["total"]))
    leaf = max(leaf_error(a, b) for a, b in zip(packed_leaves(state_b),
                                                packed_leaves(state_f)))
    if not total_rel < BF16_TOTAL or not leaf < BF16_LEAF:
        raise RuntimeError(f"bf16 training: total rel {total_rel:.3e}, worst "
                           f"param leaf {leaf:.3e}")
    print(f"phase 7: bf16: {steps} flagship steps through K6: launches "
          f"{launches}; logs total within {total_rel:.3e} of fp32, worst "
          f"param leaf {leaf:.3e}; ms/step K6 bf16 {ms_b:.4f}, K5 fp32 "
          f"{ms_f:.4f}", flush=True)
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from multi_modal_normative_modeling_tpu_torch import kernels
    from multi_modal_normative_modeling_tpu_torch.kernels import (
        _build,
        roofline,
    )
    from multi_modal_normative_modeling_tpu_torch.models import (
        Decoder,
        Encoder,
        build_model,
    )

    # ---- phase 1: the card ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # ---- phase 2: build ---------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build_library()
    _build.load_library()
    print(f"phase 2: built {lib_path.name} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    log = lib_path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    # ---- phase 3: each kernel against its plain version -------------------
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    stats = {k.__name__: {"max_abs_err": 0.0} for k in kernels.KERNELS}
    print(f"matplotlib installed: "
          f"{importlib.util.find_spec('matplotlib') is not None}", flush=True)
    with torch.no_grad():
        for folds, rows, d, c_dim in SHAPES:
            x = torch.from_numpy(rng.standard_normal(
                (folds, rows, d), dtype=np.float32)).cuda()
            c = torch.from_numpy(rng.standard_normal(
                (folds, rows, c_dim), dtype=np.float32)).cuda()
            z = torch.from_numpy(rng.standard_normal(
                (folds, rows, LATENT), dtype=np.float32)).cuda()
            enc = Encoder(d, HIDDEN, LATENT, c_dim, folds=folds,
                          generator=gen, device="cuda")
            dec = Decoder(d, HIDDEN, LATENT, c_dim, folds=folds,
                          generator=gen, device="cuda")

            mu, lv = enc.fused(x, c)
            mu_p, lv_p = enc(x, c)
            e1, r1 = check_close("fused_encoder mu", mu, mu_p, TOL)
            e2, r2 = check_close("fused_encoder logvar", lv, lv_p, TOL)
            mean = dec.fused_mean(z, c)
            e5, r5 = check_close("fused_decoder_mean", mean, dec(z, c)[0],
                                 TOL)
            recon, dev = dec.fused_pred_deviation(z, c, x)
            if not torch.equal(dev, dec.fused_pred_deviation(z, c, x)[1]):
                raise RuntimeError("fused_pred_deviation dev: two calls "
                                   "differ")
            recon_p = dec(z, c)[0]
            dev_p = kernels.reconstruction_deviation(x, recon_p)
            e3, r3 = check_close("fused_pred_deviation recon", recon,
                                 recon_p, TOL)
            e4, r4 = check_close("fused_pred_deviation dev", dev, dev_p,
                                 DEV_TOL)
            enc_ms = cuda_ms(lambda: enc.fused(x, c))
            enc_plain_ms = cuda_ms(lambda: enc(x, c))
            dec_ms = cuda_ms(lambda: dec.fused_pred_deviation(z, c, x))
            dec_plain_ms = cuda_ms(lambda: kernels.reconstruction_deviation(
                x, dec(z, c)[0]))
            mean_ms = cuda_ms(lambda: dec.fused_mean(z, c))
            mean_plain_ms = cuda_ms(lambda: dec(z, c)[0])
            enc_dev = device_ms(lambda: enc.fused(x, c))
            dec_dev = device_ms(lambda: dec.fused_pred_deviation(z, c, x))
            dec_plain_dev = device_ms(
                lambda: kernels.reconstruction_deviation(x, dec(z, c)[0]))
            mean_dev = device_ms(lambda: dec.fused_mean(z, c))
            shape = (folds, rows, d, c_dim, HIDDEN, LATENT)
            enc_w = roofline.fused_encoder(*shape)
            dec_w = roofline.fused_pred_deviation(*shape)
            mean_w = roofline.fused_decoder_mean(*shape)
            print(f"phase 3: F={folds} B={rows} D={d} C={c_dim}: "
                  f"encoder max abs err {max(e1, e2):.3e} (rel "
                  f"{max(r1, r2):.3e}), {enc_ms:.4f} ms (device "
                  f"{enc_dev:.4f}) vs plain "
                  f"{enc_plain_ms:.4f} ms, {bound_text(enc_w, enc_ms)}; "
                  f"pred_deviation recon err "
                  f"{e3:.3e} (rel {r3:.3e}), dev err {e4:.3e} (rel "
                  f"{r4:.3e}), dev bit-equal, {dec_ms:.4f} ms (device "
                  f"{dec_dev:.4f}) vs plain {dec_plain_ms:.4f} "
                  f"ms (device {dec_plain_dev:.4f}), "
                  f"{bound_text(dec_w, dec_ms)}; decoder_mean err "
                  f"{e5:.3e} (rel {r5:.3e}), "
                  f"{mean_ms:.4f} ms (device {mean_dev:.4f}) vs plain "
                  f"{mean_plain_ms:.4f} ms, "
                  f"{bound_text(mean_w, mean_ms)}", flush=True)
            for name, err, ms, dev_ms, plain, work in (
                    ("fused_encoder", max(e1, e2), enc_ms, enc_dev,
                     enc_plain_ms, enc_w),
                    ("fused_pred_deviation", max(e3, e4), dec_ms, dec_dev,
                     dec_plain_ms, dec_w),
                    ("fused_decoder_mean", e5, mean_ms, mean_dev,
                     mean_plain_ms, mean_w)):
                s = stats[name]
                s["max_abs_err"] = max(s["max_abs_err"], err)
                # the flagship scoring call's widest modality
                s["ms"], s["plain_ms"], s["work"] = ms, plain, work
                s["device_ms"] = dev_ms

    # ---- phase 3b: decoder_nll forward and backward -----------------------
    for folds, rows, hidden, d in NLL_SHAPES:
        err, rel, t = check_nll(rng, folds, rows, hidden, d)
        fwd_w = roofline.decoder_nll(folds, rows, hidden, d, backward=False)
        nll_w = roofline.decoder_nll(folds, rows, hidden, d)
        print(f"phase 3b: F={folds} B={rows} H={hidden} D={d}: decoder_nll "
              f"max abs err {err:.3e} (rel {rel:.3e}), backward bit-equal; "
              f"forward {t['fwd']:.4f} ms (device {t['fwd_device']:.4f}) vs "
              f"plain {t['plain_fwd']:.4f} ms, "
              f"{bound_text(fwd_w, t['fwd'])}; "
              f"forward+backward {t['fwd_bwd']:.4f} ms (device "
              f"{t['fwd_bwd_device']:.4f}) vs plain "
              f"{t['plain_fwd_bwd']:.4f} ms (device "
              f"{t['plain_fwd_bwd_device']:.4f}), "
              f"{bound_text(nll_w, t['fwd_bwd'])}", flush=True)
        s = stats["decoder_nll"]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        if (folds, rows, hidden, d) == NLL_TIMED:
            s["ms"], s["plain_ms"] = t["fwd_bwd"], t["plain_fwd_bwd"]
            s["work"], s["device_ms"] = nll_w, t["fwd_bwd_device"]
        if (folds, rows, hidden, d) == NLL_PPMI:
            s["ppmi"] = {"ms": t["fwd_bwd"],
                         "device_ms": t["fwd_bwd_device"],
                         "plain_ms": t["plain_fwd_bwd"],
                         "bound_ms": nll_w.bound_ms}

    # ---- phase 4: the flagship scoring call through the kernels -----------
    model = build_model("cVAE_multimodal", DIMS, HIDDEN, LATENT, C_DIM,
                        len(DIMS), folds=FOLDS, generator=gen, device="cuda")
    xes = [torch.from_numpy(rng.standard_normal(
        (FOLDS, ROWS, d), dtype=np.float32)).cuda() for d in DIMS]
    cs = [covariates(rng, FOLDS, ROWS)] * len(DIMS)
    eps = torch.randn((FOLDS, ROWS, LATENT),
                      generator=torch.Generator().manual_seed(1000)).cuda()

    kernels.reset_launch_counts()
    recons, devs = model.pred_recon_fused(xes, cs, COMBINE, eps=eps)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    for name in ("fused_encoder", "fused_pred_deviation"):
        if launches[name] == 0:
            raise RuntimeError(f"phase 4: {name} was not launched by the "
                               "scoring call")
    with torch.no_grad():
        ref = model.pred_recon(xes, cs, COMBINE, eps=eps)
    for m, d in enumerate(DIMS):
        check_close(f"modality {m} recon", recons[m], ref[m], MODEL_TOL)
        check_close(f"modality {m} deviation", devs[m],
                    model.reconstruction_deviation(xes[m], ref[m]),
                    MODEL_TOL)
        if recons[m].shape != (FOLDS, ROWS, d):
            raise RuntimeError(f"modality {m}: recon shape "
                               f"{tuple(recons[m].shape)}")

    def plain_call():
        with torch.no_grad():
            out = model.pred_recon(xes, cs, COMBINE, eps=eps)
            return [model.reconstruction_deviation(x, r)
                    for x, r in zip(xes, out)]

    kernel_wall = wall_ms(lambda: model.pred_recon_fused(xes, cs, COMBINE,
                                                         eps=eps))
    plain_wall = wall_ms(plain_call)
    kernel_dev = cuda_ms(lambda: model.pred_recon_fused(xes, cs, COMBINE,
                                                        eps=eps))
    plain_dev = cuda_ms(plain_call)
    print(f"phase 4: {FOLDS} folds x {ROWS} rows, widths {DIMS}: launches "
          f"{launches}; scoring call wall {kernel_wall:.4f} ms (plain "
          f"{plain_wall:.4f} ms), CUDA-event {kernel_dev:.4f} ms (plain "
          f"{plain_dev:.4f} ms)", flush=True)

    # the reconstruction call: encoder + decoder-mean kernels
    kernels.reset_launch_counts()
    means = model.pred_recon_means_fused(xes, cs, COMBINE, eps=eps)
    torch.cuda.synchronize()
    recon_launches = {k.__name__: k.launches for k in kernels.KERNELS}
    if recon_launches["fused_decoder_mean"] != len(DIMS):
        raise RuntimeError(f"phase 4: the reconstruction call launched "
                           f"{recon_launches}")
    for m in range(len(DIMS)):
        check_close(f"modality {m} recon mean", means[m], ref[m], MODEL_TOL)
    launches["fused_decoder_mean"] = recon_launches["fused_decoder_mean"]
    print(f"phase 4: reconstruction call launches {recon_launches}",
          flush=True)

    # ---- phase 5: training through decoder_nll -----------------------------
    train_launches = compare_training("flagship", DIMS, TRAIN_ROWS,
                                      TRAIN_EPOCHS, seed=1)
    compare_training("PPMI width", PPMI_DIMS, PPMI_ROWS, 1, seed=2)
    launches["decoder_nll"] = train_launches["decoder_nll"]

    # ---- phase 6a/6b: the fused train step against its plain version ------
    for shape in STEP_SHAPES:
        err, times = check_step(*shape)
        s5 = stats["fused_train_step"]
        s5["max_abs_err"] = max(s5["max_abs_err"], err)
        if shape[0] == "flagship":
            s5["ms"], s5["plain_ms"], s5["work"], s5["device_ms"] = times
    err, times = check_tiled()
    stats["tiled_fused_train_step"].update(max_abs_err=err, ms=times[0],
                                           plain_ms=times[1], work=times[2],
                                           device_ms=times[3])

    # ---- phase 7: training through the fused train step --------------------
    fused = compare_fused_training("flagship", DIMS, TRAIN_ROWS,
                                   TRAIN_EPOCHS, seed=3)
    compare_fused_training("PPMI width", PPMI_DIMS, PPMI_ROWS, 1, seed=4)
    tiled = bf16_training(seed=5)
    launches["fused_train_step"] = fused["fused_train_step"]
    launches["tiled_fused_train_step"] = tiled["tiled_fused_train_step"]

    sources = {"fused_encoder": ("encoder.cu", "mlp.py:121"),
               "fused_pred_deviation": ("pred_deviation.cu",
                                        "deviation.py:76"),
               "fused_decoder_mean": ("pred_deviation.cu", "mlp.py:182"),
               "decoder_nll": ("decoder_nll.cu", "decoder_nll.py:130"),
               "fused_train_step": ("train_step.cu", "train_step.py:543"),
               "tiled_fused_train_step": ("train_step_bf16.cu",
                                          "train_step_tiled.py:447")}
    missing = [name for name in sources if not launches.get(name)]
    if missing:
        raise RuntimeError(f"no launch on the main path: {missing}")
    report = []
    for name, (src, tpu) in sources.items():
        report.append({
            "name": name, "route": "cuda",
            "source": f"multi_modal_normative_modeling_tpu_torch/kernels/"
                      f"csrc/{src}",
            "replaces": f"multi_modal_normative_modeling_tpu/kernels/{tpu}",
            "launches": launches[name],
            "max_abs_err": stats[name]["max_abs_err"],
            "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"],
            # the least time the card could take at the shape `ms` was
            # taken at; no single PyTorch call computes any of the six
            "bound_ms": stats[name]["work"].bound_ms,
            "bound_by": stats[name]["work"].bound_by,
            "library_ms": None,
            # the device's time for one call's launches, replayed from a
            # CUDA graph: `ms` less this is the wrapper's host work
            "device_ms": stats[name]["device_ms"],
        })
        if "ppmi" in stats[name]:   # decoder_nll at one PPMI fold as well
            report[-1]["ppmi"] = stats[name]["ppmi"]
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
