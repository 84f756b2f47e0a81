#!/usr/bin/env python3
"""Check and time the decode+deviation kernel (K2, and K3, its mode without
x) and the decoder_nll pair (K4) on one NVIDIA GPU, for any checkout of the
port.

    python3 scripts/torch_kernel_times.py [--root DIR] [check] [time] ...

``--root DIR`` imports the package from DIR instead of this checkout (an
unpacked ``git archive`` of another commit), so that two commits are timed
in one process sequence on one card: run the script once per root, in
turns. Helpers (timers, shapes, tolerances) are this checkout's
chip_smoke.py.

  check  K2/K3 against the plain code evaluated in fp64 at chip_smoke's
         shapes and at ragged ones (no hidden layer, wide hidden layers,
         odd widths), two calls bit-equal; K4 value and gradients against
         fp64 autograd under a non-uniform cotangent (one entry 0), at
         shapes whose splits differ between the forward and the backward,
         two calls bit-equal. Prints the worst errors and where they are.
  time   per shape, CUDA-event ms of the wrapper and the device ms of its
         launches (replayed from a CUDA graph), kernel and plain in turns
         (kernel, plain, plain, kernel), beside the bound. A CUDA-event entry is
         the least of three runs of 50 calls: the wrappers' times are the
         host's, which other tenants of the machine disturb upwards.
  parts  one K4 pair and one K2 call under torch.profiler: device time by
         kernel, and the host's self time by operation.
"""
import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def event_ms(fn):
    return round(min(cs.cuda_ms(fn) for _ in range(3)), 4)

PKG = "multi_modal_normative_modeling_tpu_torch"

# (folds, rows, D, C, hidden, latent)
DECODE_SHAPES = [(f, b, d, c, cs.HIDDEN, cs.LATENT)
                 for f, b, d, c in cs.SHAPES] + [
    (3, 65, 45, 3, [], 10), (2, 33, 90, 29, [460, 460], 10),
    (1, 40, 130, 29, [64, 110, 32], 10), (2, 100, 271, 2, [57, 33], 7),
    (1, 300, 1000, 29, [110, 110], 10)]
NLL_SHAPES = cs.NLL_SHAPES + [(3, 65, 17, 130), (2, 1, 110, 64),
                              (2, 300, 529, 90), (1, 1024, 110, 300),
                              (2, 40, 130, 1000)]
DECODE_TIMED = [(1, 1000, 3485, 2), (1, 1024, 3485, 2),
                (cs.FOLDS, cs.ROWS, 270, cs.C_DIM)]
NLL_TIMED = [cs.NLL_PPMI, cs.NLL_TIMED, (5, 256, 110, 3485)]


def where(err):
    """'max e at index' of an error tensor."""
    flat = int(err.argmax())
    idx = np.unravel_index(flat, tuple(err.shape))
    return f"{err.max().item():.3e} at {tuple(int(i) for i in idx)}"


def rows(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32)).cuda()


def decoder_problem(shape, seed):
    from importlib import import_module
    models = import_module(f"{PKG}.models")
    folds, b, d, c_dim, hidden, latent = shape
    rng = np.random.default_rng(seed)
    dec = models.Decoder(d, hidden, latent, c_dim, folds=folds,
                         generator=torch.Generator().manual_seed(seed),
                         device="cuda")
    return dec, rows(rng, folds, b, latent), rows(rng, folds, b, c_dim), \
        rows(rng, folds, b, d)


def check_decode(kernels):
    for seed, shape in enumerate(DECODE_SHAPES):
        dec, z, c, x = decoder_problem(shape, seed)
        with torch.no_grad():
            recon, dev = dec.fused_pred_deviation(z, c, x)
            mean = dec.fused_mean(z, c)
            again = dec.fused_pred_deviation(z, c, x)
            hidden = [(w.double(), b.double()) for w, b in dec.hidden_layers()]
            head = tuple(t.double() for t in dec.mean.pair())
            ref, dev_ref = kernels.pred_deviation_reference(
                hidden, head, z.double(), c.double(), x.double(),
                dec.non_linear)
        torch.cuda.synchronize()
        e_recon = (recon.double() - ref).abs()
        e_dev = ((dev.double() - dev_ref).abs() / dev_ref.abs())
        equal = (torch.equal(recon, mean) and torch.equal(dev, again[1])
                 and torch.equal(recon, again[0]))
        print(f"K2/K3 {shape}: recon err {where(e_recon)}, dev rel err "
              f"{where(e_dev)}, K3 == K2's recon and repeats bit-equal: "
              f"{equal}", flush=True)
        if (not equal or e_recon.max() > 1e-5 or e_dev.max() > 1e-4
                or not torch.isfinite(recon).all()):
            raise RuntimeError(f"K2/K3 {shape} failed")


def nll_problem(shape, seed):
    folds, b, hidden, d = shape
    rng = np.random.default_rng(seed)
    g = rows(rng, folds, b, hidden, scale=0.5).requires_grad_()
    w = rows(rng, folds, d, hidden, scale=0.05).requires_grad_()
    bias = rows(rng, folds, d, scale=0.1).requires_grad_()
    lvo = (rows(rng, folds, 1, d, scale=0.1) - 1.0).requires_grad_()
    with torch.no_grad():
        x = (g @ w.mT + bias[:, None] + torch.exp(0.5 * lvo)
             * rows(rng, folds, b, d))
    mask = torch.ones(folds, b, device="cuda")
    for f in range(folds):
        mask[f, max(b - 2 - f, 0):] = 0.0
    n = torch.clamp(mask.sum(-1), min=1.0)
    # distinct cotangents, the last one 0
    a = torch.linspace(1.5, 0.0, folds, device="cuda") if folds > 1 else \
        torch.full((1,), 0.75, device="cuda")
    return (g, w, bias, lvo), x, mask, n, a


def check_nll(nll):
    for seed, shape in enumerate(NLL_SHAPES):
        params, x, mask, n, a = nll_problem(shape, seed)

        def run(fn, cast=lambda t: t):
            leaves = [cast(p.detach()).requires_grad_() for p in params]
            ll = fn(*leaves, cast(x), cast(mask), cast(n))
            return ll, torch.autograd.grad((cast(a) * ll).sum(), leaves)

        ll, grads = run(nll.decoder_nll)
        ll64, grads64 = run(nll.decoder_nll_reference, lambda t: t.double())
        again = run(nll.decoder_nll)
        torch.cuda.synchronize()
        tol = cs.NLL_GRAD_TOL[3485 if shape[3] > 270 else 270]
        report, ok = [], True
        rel = ((ll.double() - ll64).abs()
               / ll64.abs().clamp_min(1e-30)).max().item()
        ok &= rel <= 1e-5
        for name, got, want, rep in zip(("dg", "dw", "db", "dlvo"), grads,
                                        grads64, again[1]):
            err = (got.double() - want).abs()
            over = (err - (tol["atol"] + tol["rtol"] * want.abs())).max()
            same = torch.equal(got, rep)
            ok &= bool(over <= 0) and same and bool(
                torch.isfinite(got).all())
            report.append(f"{name} {where(err)}"
                          f"{'' if same else ' NOT bit-equal'}")
        zero = (all(float(t[-1].abs().max()) == 0 for t in grads)
                if shape[0] > 1 else "n/a")
        print(f"K4 {shape}: ll rel err {rel:.3e}; " + "; ".join(report)
              + f"; zero-cotangent fold's gradients zero: {zero}",
              flush=True)
        if not ok:
            raise RuntimeError(f"K4 {shape} failed")


def time_decode(kernels, roofline):
    for shape in DECODE_TIMED:
        full = (*shape, cs.HIDDEN, cs.LATENT)
        dec, z, c, x = decoder_problem(full, 0)
        with torch.no_grad():
            calls = {
                "K2": lambda: dec.fused_pred_deviation(z, c, x),
                "K2 plain": lambda: kernels.reconstruction_deviation(
                    x, dec(z, c)[0]),
                "K3": lambda: dec.fused_mean(z, c),
                "K3 plain": lambda: dec(z, c)[0]}
            order = ["K2", "K2 plain", "K3", "K3 plain", "K3 plain", "K3",
                     "K2 plain", "K2"]
            ev, dv = {}, {}
            for name in order:
                ev.setdefault(name, []).append(event_ms(calls[name]))
            for name in order:
                dv.setdefault(name, []).append(round(
                    cs.device_ms(calls[name]), 4))
        f, b, d, c_dim = shape
        args = (f, b, d, c_dim, cs.HIDDEN, cs.LATENT)
        print(f"decode {shape}: bound K2 "
              f"{roofline.fused_pred_deviation(*args).bound_ms:.5f} ms, K3 "
              f"{roofline.fused_decoder_mean(*args).bound_ms:.5f} ms; "
              f"CUDA-event ms {ev}; device ms {dv}", flush=True)


def time_nll(nll, roofline):
    for shape in NLL_TIMED:
        params, x, mask, n, _ = nll_problem(shape, 0)

        def pair(fn):
            # fresh leaves: see chip_smoke.check_nll
            leaves = [p.detach().requires_grad_() for p in params]
            ll = fn(*leaves, x, mask, n)
            return torch.autograd.grad(ll.sum(), leaves)

        def fwd(fn):
            with torch.no_grad():
                return fn(*params, x, mask, n)

        calls = {"fwd": lambda: fwd(nll.decoder_nll),
                 "fwd plain": lambda: fwd(nll.decoder_nll_reference),
                 "pair": lambda: pair(nll.decoder_nll),
                 "pair plain": lambda: pair(nll.decoder_nll_reference)}
        order = ["fwd", "fwd plain", "pair", "pair plain", "pair plain",
                 "pair", "fwd plain", "fwd"]
        ev, dv = {}, {}
        for name in order:
            ev.setdefault(name, []).append(event_ms(calls[name]))
        for name in order:
            dv.setdefault(name, []).append(round(cs.device_ms(calls[name]),
                                                 4))
        print(f"decoder_nll {shape}: bound forward "
              f"{roofline.decoder_nll(*shape, backward=False).bound_ms:.5f} "
              f"ms, pair {roofline.decoder_nll(*shape).bound_ms:.5f} ms; "
              f"CUDA-event ms {ev}; device ms {dv}", flush=True)


def parts(nll):
    from torch.profiler import ProfilerActivity, profile

    def show(what, fn, iters=50):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = prof.key_averages()
        print(f"{what}: per call", flush=True)
        for e in sorted(rows, key=lambda e: -e.device_time_total):
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and e.device_time_total > 0):
                print(f"    device {e.device_time_total / iters:8.2f} us  "
                      f"x{e.count / iters:.1f}  {e.key[:80]}")
        for e in sorted(rows, key=lambda e: -e.self_cpu_time_total)[:12]:
            if e.device_type != torch.autograd.DeviceType.CUDA:
                print(f"    host   {e.self_cpu_time_total / iters:8.2f} us  "
                      f"x{e.count / iters:.1f}  {e.key[:80]}")

    for shape in (cs.NLL_PPMI, cs.NLL_TIMED):
        params, x, mask, n, _ = nll_problem(shape, 0)

        def pair(fn=nll.decoder_nll):
            ll = fn(*params, x, mask, n)
            return torch.autograd.grad(ll.sum(), params)

        show(f"K4 pair {shape}", pair)
    for shape in DECODE_TIMED[1:]:
        dec, z, c, x = decoder_problem((*shape, cs.HIDDEN, cs.LATENT), 0)
        with torch.no_grad():
            show(f"K2 {shape}", lambda: dec.fused_pred_deviation(z, c, x))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=str(ROOT))
    parser.add_argument("modes", nargs="*", default=["check"])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from importlib import import_module
    kernels = import_module(f"{PKG}.kernels")
    nll = import_module(f"{PKG}.kernels.decoder_nll")
    build = import_module(f"{PKG}.kernels._build")
    roofline = import_module(f"{PKG}.kernels.roofline")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = build.build_library()
    build.load_library()
    print(f"package from {Path(kernels.__file__).parents[2]}; built "
          f"{lib.name}", flush=True)
    # registers and spills of this script's kernels
    keep = False
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            keep = any(k in line for k in ("nll_", "pred_deviation",
                                           "sum_parts", "sum_splits"))
            if keep:
                print("  ptxas:", line.split("'")[1][:100])
        elif keep and ("registers" in line or "spill" in line):
            print("  ptxas:  ", line.strip())
    for mode in args.modes:
        if mode == "check":
            check_decode(kernels)
            check_nll(nll)
        elif mode == "time":
            time_decode(kernels, roofline)
            time_nll(nll, roofline)
        elif mode == "parts":
            parts(nll)
        else:
            raise SystemExit(f"unknown mode {mode}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
