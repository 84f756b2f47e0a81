#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root

Phases (any failure exits non-zero, with no result line):
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from kernels/csrc/ with nvcc (sm_90a);
  3. hold each kernel against its plain torch version on the card (TF32
     off) at the test stage's shapes, and time both;
  4. score 5 folds of the flagship model (cVAE_multimodal, UCA-gPoE widths
     4x[90, 90, 90, 270], c 29, hidden [110, 110], latent 10, 1024 padded
     rows per fold, seeded random weights) through the test stage's scoring
     entry, count the kernel launches of that one call, compare it with the
     plain path on the same eps, and time both.

The last line is {"ok": true, "device": {"platform": "gpu", ...}}; the line
before it holds the kernels' launches, errors and times.
"""
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


def covariates(rng, folds, rows):
    """One-hot age (27 bins) + gender (2 bins), as the test stage feeds."""
    c = np.zeros((folds, rows, C_DIM), np.float32)
    idx = np.arange(rows)
    for f in range(folds):
        c[f, idx, rng.integers(0, 27, rows)] = 1.0
        c[f, idx, 27 + rng.integers(0, 2, rows)] = 1.0
    return torch.from_numpy(c).cuda()


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
    for name, n in launches.items():
        if n == 0:
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

    sources = {"fused_encoder": ("encoder.cu", "mlp.py:121"),
               "fused_pred_deviation": ("pred_deviation.cu",
                                        "deviation.py:76")}
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
