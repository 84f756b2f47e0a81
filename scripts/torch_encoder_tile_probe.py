#!/usr/bin/env python3
"""The encoder kernel (K1) on 64-row block tiles with an 8 x 4 lane tile,
beside the repository's 32-row tiles with a 4 x 4 lane tile.

    python3 scripts/torch_encoder_tile_probe.py     # on a machine with one GPU

A product on ``csrc/tile_product.cuh`` makes eight 128-bit shared-memory
loads for 64 FFMA; a lane that owns 8 rows x 4 columns makes twelve for
128. That needs block tiles of 64 rows, which halves the row tiles a launch
has. This script measures the trade for K1 without touching the repository's
kernels: it copies ``tile_product.cuh`` and ``encoder.cu`` into a scratch
directory (``chip_checkout/tile_probe/``, ignored by git), sets TM = 64 and
RM = 8 in the copy (and, in a second copy, one block an SM in the launch
bounds, which lifts the cap of 128 registers a thread), builds each copy
alone with nvcc and calls ``mmnm_encoder`` through ctypes at the two timed
shapes, with the reduction cut into each of a few numbers of splits. Every
result is first held to the repository's kernel on the same inputs (rtol and
atol 1e-5). Prints device ms (CUDA-graph replays) and CUDA-event ms of each.

Two more copies keep the 32-row tiles and take something out, to show where
the kernel's time goes (their results are wrong on purpose and are not
checked; they run the repository's plan): one skips the multiply of every
staged chunk, one loads the weights of a product's first chunk only, one
does both (what is left is the launch, the slice's copy, the waits and
barriers, the epilogues and the heads).
"""
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from multi_modal_normative_modeling_tpu_torch.kernels import (  # noqa: E402
    _build,
    mlp,
)
from multi_modal_normative_modeling_tpu_torch.models import (  # noqa: E402
    Encoder,
)

PROBE = ROOT / "chip_checkout" / "tile_probe"
TALL = [("constexpr int TM = 32;", "constexpr int TM = 64;"),
        ("constexpr int RM = 4;", "constexpr int RM = 8;")]
ONE_BLOCK = [("__launch_bounds__(THREADS, 2)", "__launch_bounds__(THREADS, 1)")]
NO_MULTIPLY = [
    ("      chunk_nt(acc, ap, ring + (s % SLOTS) * SLOT_FLOATS, kc, ln);\n",
     "")]
FIRST_LOAD_ONLY = [("    if (s < total) {\n      stage_nt(",
                    "    if (s < total && s % nk == 0) {\n      stage_nt(")]
# (folds, rows, D, C) and the K splits to try on 64-row tiles
SHAPES = [((1, 1024, 3485, 2), (4, 8, 11, 16, 22)),
          ((cs.FOLDS, cs.ROWS, 270, cs.C_DIM), (1, 2, 4))]


def build(name, patches):
    out = PROBE / name
    out.mkdir(parents=True)
    for src in ("tile_product.cuh", "encoder.cu"):
        text = (_build.SRC_DIR / src).read_text()
        for old, new in patches:
            if old in text:
                if text.count(old) != 1:
                    raise RuntimeError(f"patch applies twice: {old!r}")
                text = text.replace(old, new)
        (out / src).write_text(text)
    lib = out / "libencoder.so"
    done = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
         str(out / "encoder.cu")], capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(done.stdout + done.stderr)
    for line in (done.stdout + done.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas ({name}):", line.strip(), flush=True)
    return _build._declare_encoder(ctypes.CDLL(str(lib)))


def tall_call(lib, enc, x, c, splits):
    """One launch of a 64-row library: (call, shared-memory bytes)."""
    folds, rows, d = x.shape
    c_dim = c.shape[2]
    layers = [*enc.hidden_layers(), enc.mu.pair(), enc.logvar.pair()]
    widths = [w.shape[1] for w, _ in layers]
    w, b, n = _build.launch_args(layers, widths)
    chunks = -(-(d + c_dim) // _build.TILE_DEPTH)
    per = -(-chunks // splits)
    splits = -(-chunks // per)
    k_per = per * _build.TILE_DEPTH
    sizes = (ctypes.c_longlong * 4)()
    lib.mmnm_encoder_sizes(k_per, max(widths[:-2]), sizes)
    if sizes[3] > _build.MAX_SMEM_BYTES:
        return None, splits, sizes[3]
    tiles = -(-rows // sizes[0])
    scratch = torch.zeros(folds * tiles + splits * folds * rows * widths[0],
                          device="cuda")
    z_dim = widths[-1]
    mu = torch.empty(folds, rows, z_dim, device="cuda")
    lv = torch.empty(folds, rows, z_dim, device="cuda")

    def call():
        rc = lib.mmnm_encoder(
            x.data_ptr(), c.data_ptr(), mu.data_ptr(), lv.data_ptr(),
            scratch.data_ptr(), folds, rows, d, c_dim, z_dim,
            len(layers) - 2, w, b, n, 1, splits, k_per,
            _build.stream_of(x.device))
        _build.check_launch(lib, rc, "tall fused_encoder")
        return mu, lv

    return call, splits, sizes[3]


def main():
    if not torch.cuda.is_available():
        print("torch_encoder_tile_probe: no CUDA device is available",
              file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip(), flush=True)
    if PROBE.exists():
        shutil.rmtree(PROBE)
    libs = {"64 rows, 8 x 4 a lane": build("tall", TALL),
            "64 rows, 8 x 4 a lane, one block an SM":
                build("tall_one", TALL + ONE_BLOCK)}
    probes = {"32 rows, no multiply": build("no_multiply", NO_MULTIPLY),
              "32 rows, weights loaded for a product's first chunk only":
                  build("first_load", FIRST_LOAD_ONLY),
              "32 rows, neither":
                  build("neither", NO_MULTIPLY + FIRST_LOAD_ONLY)}
    for shape, tries in SHAPES:
        folds, rows, d, c_dim = shape
        enc = Encoder(d, cs.HIDDEN, cs.LATENT, c_dim, folds=folds,
                      generator=torch.Generator().manual_seed(0),
                      device="cuda")
        gen = torch.Generator().manual_seed(1)
        x = torch.randn(folds, rows, d, generator=gen).cuda()
        c = torch.randn(folds, rows, c_dim, generator=gen).cuda()
        with torch.no_grad():
            want = [t.clone() for t in enc.fused(x, c)]
            times = {"32 rows, 4 x 4 a lane (the repository's, its plan)": (
                round(cs.device_ms(lambda: enc.fused(x, c)), 4),
                round(cs.cuda_ms(lambda: enc.fused(x, c)), 4))}
            for name, lib in libs.items():
                for splits in tries:
                    call, splits, smem = tall_call(lib, enc, x, c, splits)
                    key = f"{name}, {splits} splits ({smem} B)"
                    if call is None:
                        times[key] = "does not fit a block"
                        continue
                    for got, ref in zip(call(), want):
                        torch.testing.assert_close(got, ref, rtol=1e-5,
                                                   atol=1e-5)
                    times[key] = (round(cs.device_ms(call), 4),
                                  round(cs.cuda_ms(call), 4))
            own = mlp.plan(folds, rows, d + c_dim, tuple(cs.HIDDEN),
                           cs.LATENT).splits
            for name, lib in probes.items():
                call, _, _ = tall_call(lib, enc, x, c, own)
                times[f"{name}, {own} splits"] = (
                    round(cs.device_ms(call), 4), round(cs.cuda_ms(call), 4))
            again = (round(cs.device_ms(lambda: enc.fused(x, c)), 4),
                     round(cs.cuda_ms(lambda: enc.fused(x, c)), 4))
        print(f"encode {shape}: (device ms, CUDA-event ms): {times}; the "
              f"repository's again {again}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
