"""Which row reductions of a fold-stacked step give each fold the same bits
whatever the number of folds stacked?

For [F, B, N] operands (B = 256 rows, the batch; N the widths of the
flagship and the ADHD models) this computes several ways of summing over
the rows, at F = 5 and at F = 10 on the same per-fold data, and reports
for each whether the first five folds agree bit for bit:

  outer      t.sum(-2), autograd's bias gradient and the loss's row sums
  inner      t.mT.contiguous().sum(-1)
  gemm       ones[1, B] @ t (a batched product)
  fold loop  one reduction per fold
  pairwise   a fixed tree of elementwise adds over the rows

and the same for [F, B] (the masked means over rows) and the modality sum
of [M, F, B, Z] statistics.

    python3 scripts/torch_fold_reduce_probe.py [--device cuda]

Prints one JSON object as its last line.
"""
from __future__ import annotations

import argparse
import json

import torch


def pairwise(t, dim):
    t = t.movedim(dim, 0)
    while t.shape[0] > 1:
        if t.shape[0] % 2:
            t = torch.cat([t, torch.zeros_like(t[:1])])
        t = t[0::2] + t[1::2]
    return t[0]


METHODS = {
    "outer": lambda t: t.sum(-2),
    "inner": lambda t: t.mT.contiguous().sum(-1),
    "gemm": lambda t: (torch.ones(t.shape[-2], device=t.device)[None, None]
                       @ t)[:, 0],
    "fold loop": lambda t: torch.stack([t[f].sum(-2)
                                        for f in range(t.shape[0])]),
    "pairwise": lambda t: pairwise(t, -2),
}
ROW_METHODS = {
    "sum(-1)": lambda t: t.sum(-1),
    "fold loop": lambda t: torch.stack([t[f].sum(-1)
                                        for f in range(t.shape[0])]),
    "pairwise": lambda t: pairwise(t, -1),
    "gemm": lambda t: (t[:, None] @ torch.ones(t.shape[-1], 1,
                                               device=t.device))[:, 0, 0],
}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    device = parser.parse_args().device
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    out = {}
    for n in (1, 10, 29, 39, 90, 110, 116, 145, 270):
        t = torch.randn((10, 256, n), generator=gen).to(device)
        for name, fn in METHODS.items():
            a, b = fn(t)[:5], fn(t[:5].contiguous())
            out[f"[F,256,{n}] {name}"] = bool(torch.equal(a, b))
    for rows in (64, 256):
        t = torch.randn((10, rows), generator=gen).to(device)
        for name, fn in ROW_METHODS.items():
            a, b = fn(t)[:5], fn(t[:5].contiguous())
            out[f"[F,{rows}] {name}"] = bool(torch.equal(a, b))
    for m in (2, 4):
        t = torch.randn((m, 10, 256, 10), generator=gen).to(device)
        out[f"[{m},F,256,10] sum(0)"] = bool(torch.equal(
            t.sum(0)[:5], t[:, :5].contiguous().sum(0)))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
