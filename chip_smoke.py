#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root

Phases (any failure exits non-zero, with no result line):
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from kernels/csrc/ with nvcc (sm_90a);
  3. hold the encoder and decode+deviation kernels against their plain torch
     versions on the card (TF32 off) at the test stage's shapes, and time
     both;
  3b. hold the decoder_nll kernel pair (forward and backward) against its
     plain version plus autograd, with ragged row masks, at training
     shapes; check that two backward calls are bit-equal; time both;
  4. score 5 folds of the flagship model (cVAE_multimodal, UCA-gPoE widths
     4x[90, 90, 90, 270], c 29, hidden [110, 110], latent 10, 1024 padded
     rows per fold, seeded random weights) through the test stage's scoring
     entry, count the kernel launches of that one call, compare it with the
     plain path on the same eps, and time both;
  5. train the flagship model (5 folds of 512 seeded subjects, one fold's
     last batch ragged, batch 256, 10 epochs) through MultiFoldTrainer with
     the --fused_decoder loss, count the decoder_nll launches of that run,
     and hold it against the plain loss from the same init and eps; then a
     few steps at PPMI width (3 x 3485, one fold) the same way; ms per step
     of both.

The last line is {"ok": true, "device": {"platform": "gpu", ...}}; the line
before it holds the kernels' launches, errors and times.
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
# flagship scoring call's own shapes
SHAPES = [(1, 7, 90, 29), (1, 300, 270, 29), (1, 1024, 3485, 2),
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
NLL_VALUE_TOL = dict(rtol=1e-5, atol=0.0)
NLL_GRAD_TOL = {90: dict(rtol=1e-4, atol=1e-6), 270: dict(rtol=1e-4, atol=1e-6),
                3485: dict(rtol=1e-3, atol=1e-5)}

# training (bench.py:29-36): 512 subjects per fold, the last fold 500 so its
# second batch is ragged; and the PPMI width (bench.py:45-46)
TRAIN_ROWS = [512, 512, 512, 512, 500]
TRAIN_EPOCHS = 10
BATCH = 256
PPMI_DIMS = [3485, 3485, 3485]
PPMI_ROWS = [2500]
LOG_TOL = dict(rtol=1e-4, atol=0.0)
PARAM_TOL = dict(rtol=5e-3, atol=1e-5)


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from multi_modal_normative_modeling_tpu_torch import kernels
    from multi_modal_normative_modeling_tpu_torch.kernels import _build
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
            recon, dev = dec.fused_pred_deviation(z, c, x)
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
            print(f"phase 3: F={folds} B={rows} D={d} C={c_dim}: "
                  f"encoder max abs err {max(e1, e2):.3e} (rel "
                  f"{max(r1, r2):.3e}), {enc_ms:.4f} ms vs plain "
                  f"{enc_plain_ms:.4f} ms; pred_deviation recon err "
                  f"{e3:.3e} (rel {r3:.3e}), dev err {e4:.3e} (rel "
                  f"{r4:.3e}), {dec_ms:.4f} ms vs plain {dec_plain_ms:.4f} "
                  "ms", flush=True)
            for name, err, ms, plain in (
                    ("fused_encoder", max(e1, e2), enc_ms, enc_plain_ms),
                    ("fused_pred_deviation", max(e3, e4), dec_ms,
                     dec_plain_ms)):
                s = stats[name]
                s["max_abs_err"] = max(s["max_abs_err"], err)
                # the flagship scoring call's widest modality
                s["ms"], s["plain_ms"] = ms, plain

    # ---- phase 3b: decoder_nll forward and backward -----------------------
    for folds, rows, hidden, d in NLL_SHAPES:
        err, rel, t = check_nll(rng, folds, rows, hidden, d)
        print(f"phase 3b: F={folds} B={rows} H={hidden} D={d}: decoder_nll "
              f"max abs err {err:.3e} (rel {rel:.3e}), backward bit-equal; "
              f"forward {t['fwd']:.4f} ms vs plain {t['plain_fwd']:.4f} ms, "
              f"forward+backward {t['fwd_bwd']:.4f} ms vs plain "
              f"{t['plain_fwd_bwd']:.4f} ms", flush=True)
        s = stats["decoder_nll"]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        if (folds, rows, hidden, d) == NLL_TIMED:
            s["ms"], s["plain_ms"] = t["fwd_bwd"], t["plain_fwd_bwd"]

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

    # ---- phase 5: training through decoder_nll -----------------------------
    train_launches = compare_training("flagship", DIMS, TRAIN_ROWS,
                                      TRAIN_EPOCHS, seed=1)
    compare_training("PPMI width", PPMI_DIMS, PPMI_ROWS, 1, seed=2)
    launches["decoder_nll"] = train_launches["decoder_nll"]

    sources = {"fused_encoder": ("encoder.cu", "mlp.py:121"),
               "fused_pred_deviation": ("pred_deviation.cu",
                                        "deviation.py:76"),
               "decoder_nll": ("decoder_nll.cu", "decoder_nll.py:130")}
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
        })
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
