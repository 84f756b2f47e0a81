#!/usr/bin/env python3
"""Where a fused train step's device time goes: products, loads, or the rest.

    python3 scripts/torch_step_probe.py        # on a machine with one GPU

Copies the port into a scratch directory (``chip_checkout/probe/``, ignored
by git), patches two switches into the copy of ``csrc/train_step.cuh``
(read from the environment variable MMNM_PROBE at each step: bit 0 skips
the multiply of every staged chunk of the row-owned passes, bit 1 skips the
loads of every chunk but a product's first), builds the copy and times one
K5 step at the flagship and at PPMI width under torch.profiler with the
switches off, each on, both on, and off again. The results of a patched step
are wrong on purpose: only the times mean anything. The difference between
"off" and "no multiply" is what the products cost on top of everything
else; what remains with both on is barriers, epilogues, elementwise passes
and launches. The weight-gradient pass has its own loop and is not
switched.

The kernels of the repository are not touched.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
PROBE = ROOT / "chip_checkout" / "probe"
PACKAGE = "multi_modal_normative_modeling_tpu_torch"

PATCHES = [
    ("enum Combine { POE = 0, GPOE = 1, MOE = 2, MOPOE = 3 };",
     "enum Combine { POE = 0, GPOE = 1, MOE = 2, MOPOE = 3 };\n"
     "__constant__ int g_probe;"),
    ("        stage_a(nxt, a, (c + 1) * BK, K);\n"
     "        stage_w<MODE>(nxt + TM * LDA, w, ldw, (c + 1) * BK, K, n0, N);\n",
     "        if (!(g_probe & 2)) {\n"
     "        stage_a(nxt, a, (c + 1) * BK, K);\n"
     "        stage_w<MODE>(nxt + TM * LDA, w, ldw, (c + 1) * BK, K, n0, N);\n"
     "        }\n"),
    ("      if (n0 + 32 * ln.wc >= N) {",
     "      if (n0 + 32 * ln.wc >= N || (g_probe & 1)) {"),
    ("  Scratch<T> s;\n  carve<T>(d, work, s);\n\n  const int row_tiles",
     "  Scratch<T> s;\n  carve<T>(d, work, s);\n  {\n"
     "    const char* e = getenv(\"MMNM_PROBE\");\n"
     "    const int v = e ? atoi(e) : 0;\n"
     "    cudaMemcpyToSymbolAsync(g_probe, &v, sizeof(int), 0,\n"
     "                            cudaMemcpyHostToDevice, stream);\n  }\n\n"
     "  const int row_tiles"),
    ("#include <stdint.h>\n", "#include <stdint.h>\n#include <stdlib.h>\n"),
]
SWITCHES = [(0, "off"), (1, "no multiply"), (2, "no loads"),
            (3, "neither"), (0, "off")]


def make_copy():
    if PROBE.exists():
        shutil.rmtree(PROBE)
    PROBE.mkdir(parents=True)
    shutil.copytree(ROOT / PACKAGE, PROBE / PACKAGE,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", PROBE / "chip_smoke.py")
    source = PROBE / PACKAGE / "kernels" / "csrc" / "train_step.cuh"
    text = source.read_text()
    for old, new in PATCHES:
        if text.count(old) != 1:
            raise RuntimeError(f"probe patch does not apply: {old[:50]!r}")
        text = text.replace(old, new)
    source.write_text(text)


def main():
    if not torch.cuda.is_available():
        print("torch_step_probe: no CUDA device is available",
              file=sys.stderr)
        return 2
    make_copy()
    sys.path.insert(0, str(PROBE))
    import chip_smoke as cs
    from multi_modal_normative_modeling_tpu_torch.kernels.train_step import (
        FusedTrainStep,
    )
    from torch.profiler import ProfilerActivity, profile

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip(), flush=True)
    for shape in (cs.STEP_SHAPES[0], cs.STEP_SHAPES[-1]):
        name, dims, hidden, folds, rows, c_dim, z_dim, combine = shape
        stacked, packed, x, c, eps, mask = cs.step_problem(
            dims, hidden, folds, rows, c_dim, z_dim, seed=len(name) + rows)
        step = FusedTrainStep(stacked, combine)
        named = step.pad_params(packed)
        xx, cc, rm, nv = step.pack_batch(x, c, mask)
        batch = (xx, cc, eps, rm, nv)
        for value, label in SWITCHES:
            os.environ["MMNM_PROBE"] = str(value)
            ms = cs.cuda_ms(lambda: step.loss_and_grads_flat(named, *batch))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    step.loss_and_grads_padded(named, *batch)
                torch.cuda.synchronize()
            rows_ = sorted((e for e in prof.key_averages()
                            if "mmnm_ts::" in e.key),
                           key=lambda e: -e.device_time_total)
            per_kernel = ", ".join(
                f"{e.key.split('mmnm_ts::')[1].split('<')[0]} "
                f"{e.device_time_total / 10 / 1e3:.4f}" for e in rows_)
            print(f"K5 {name}, {label}: {ms:.4f} ms per step (CUDA events); "
                  f"device ms per kernel: {per_kernel}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
