"""The least time an H100 could take for one launch of each kernel.

For every kernel of the port, the floating-point operations and the
device-memory bytes of one launch, from its shapes alone, and the bound
they give on one NVIDIA H100 SXM:

    bound = max(FLOP / peak rate of the operand type, bytes / 3.35 TB/s)

Counting rules (the same for every kernel, so the shares compare):
  * FLOP are the matrix products the function needs, 2 per multiply-add.
    Elementwise work (bias, LeakyReLU, the NLL, fusion) is a few operations
    per output element and is left out; no kernel here is bound by it.
  * Bytes are each input read once and each output written once at its
    stored width, whatever the kernel re-reads or keeps in a workspace.
  * A gradient kernel needs, per forward product A W, the two backward
    products A^T dY and dY W^T, except where no gradient flows to A (the
    batch x and the covariates c).
  * Rows are the rows the caller hands over, padded or masked ones too:
    the kernels compute them and mask their contribution.

The peaks are NVIDIA's data-sheet rates at the 700 W power limit: 67 TFLOP/s
for fp32 outside the tensor cores (every fp32 kernel here; TF32 would not
hold their tolerances), 989 TFLOP/s for bf16 products with fp32 accumulation
(the bf16 path of the tiled train step), 3.35 TB/s of device memory.

Pure Python: shapes in, numbers out.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


@dataclasses.dataclass(frozen=True)
class Work:
    """One launch's work and the bound it gives."""
    flop: float
    bytes: float
    peak_flops: float = PEAK_FP32_FLOPS

    @property
    def flop_ms(self) -> float:
        return self.flop / self.peak_flops * 1e3

    @property
    def bytes_ms(self) -> float:
        return self.bytes / PEAK_BYTES_PER_S * 1e3

    @property
    def bound_ms(self) -> float:
        return max(self.flop_ms, self.bytes_ms)

    @property
    def bound_by(self) -> str:
        return "operations" if self.flop_ms >= self.bytes_ms else "bytes"

    @property
    def peak_name(self) -> str:
        return ("989 TFLOP/s bf16" if self.peak_flops == PEAK_BF16_FLOPS
                else "67 TFLOP/s fp32")

    def share(self, ms: float) -> float:
        """bound / measured time."""
        return self.bound_ms / ms

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flop + other.flop, self.bytes + other.bytes,
                    self.peak_flops)


def _chain(k_in: int, widths: Sequence[int]):
    """(multiply-adds per row, parameter count) of a dense chain."""
    mac = params = 0
    for n in widths:
        mac += k_in * n
        params += k_in * n + n
        k_in = n
    return mac, params


def encoder_mac(d: int, c: int, hidden: Sequence[int], z: int):
    """(MAC per row, parameters) of one conditional encoder: [x | c]
    through the hidden layers, then the mu and logvar heads."""
    mac, params = _chain(d + c, hidden)
    return mac + 2 * hidden[-1] * z, params + 2 * (hidden[-1] * z + z)


def decoder_mac(d: int, c: int, hidden: Sequence[int], z: int):
    """(MAC per row, parameters) of one conditional decoder's mean path:
    [z | c] through the reversed hidden layers, then the mean head."""
    rev = list(hidden)[::-1]
    mac, params = _chain(z + c, rev)
    return mac + rev[-1] * d, params + rev[-1] * d + d


def fused_encoder(folds: int, rows: int, d: int, c: int,
                  hidden: Sequence[int], z: int) -> Work:
    """K1: x, c and the parameters in; mu and logvar out."""
    mac, params = encoder_mac(d, c, hidden, z)
    n = folds * rows
    return Work(2.0 * n * mac,
                4.0 * (n * (d + c) + folds * params + 2 * n * z))


def fused_decoder_mean(folds: int, rows: int, d: int, c: int,
                       hidden: Sequence[int], z: int) -> Work:
    """K3: z, c and the parameters in; the reconstruction out."""
    mac, params = decoder_mac(d, c, hidden, z)
    n = folds * rows
    return Work(2.0 * n * mac, 4.0 * (n * (z + c) + folds * params + n * d))


def fused_pred_deviation(folds: int, rows: int, d: int, c: int,
                         hidden: Sequence[int], z: int) -> Work:
    """K2: K3 plus x in and the per-row deviation out."""
    base = fused_decoder_mean(folds, rows, d, c, hidden, z)
    n = folds * rows
    return Work(base.flop, base.bytes + 4.0 * (n * d + n))


def decoder_nll(folds: int, rows: int, hidden: int, d: int,
                backward: bool = True) -> Work:
    """K4: the mean head g W^T + b with the masked Gaussian NLL. Forward:
    g, W, b, lvo, x, the mask and n in, one value per fold out. With the
    backward, the same inputs again and dg, dW, db, dlvo out, and the two
    backward products dmean W and dmean^T g."""
    n = folds * rows
    inputs = n * hidden + folds * (hidden * d + 2 * d) + n * d + n + folds
    flop = 2.0 * n * hidden * d
    nbytes = 4.0 * (inputs + folds)
    if backward:
        flop *= 3
        nbytes += 4.0 * (inputs + folds
                         + n * hidden + folds * (hidden * d + 2 * d))
    return Work(flop, nbytes)


def train_step_mac(dims: Sequence[int], c: int, hidden: Sequence[int],
                   z: int):
    """Per row of one fold, summed over the modalities at their true
    widths: (forward MAC, backward MAC, parameters). The backward is, per
    forward product, the weight gradient (as many MAC) and the input
    gradient, which the first encoder layer does not need at all and the
    first decoder layer needs only for its z rows."""
    fwd = bwd = params = 0
    rev = list(hidden)[::-1]
    for d in dims:
        e_mac, e_par = encoder_mac(d, c, hidden, z)
        d_mac, d_par = decoder_mac(d, c, hidden, z)
        fwd += e_mac + d_mac
        no_input_grad = (d + c) * hidden[0] + c * rev[0]
        bwd += 2 * (e_mac + d_mac) - no_input_grad
        params += e_par + d_par + d      # + lvo
    return fwd, bwd, params + len(dims)  # + alpha


def fused_train_step(folds: int, rows: int, dims: Sequence[int], c: int,
                     hidden: Sequence[int], z: int,
                     bf16: bool = False) -> Work:
    """K5 (fp32) and K6 (fp32, or bf16 operands): one whole train step.
    In: x at each modality's width, c, eps, the row mask, n and the
    parameters; out: every gradient (fp32) and three losses per fold. With
    bf16 the batch and the weight matrices are stored in 2 bytes and the
    products run at the tensor cores' rate."""
    fwd, bwd, params = train_step_mac(dims, c, hidden, z)
    n = folds * rows
    small = sum(_bias_like(d, hidden, z) for d in dims) + len(dims)
    weights = params - small
    wide = 2.0 if bf16 else 4.0
    nbytes = (wide * (n * sum(dims) + n * c + folds * weights)
              + 4.0 * (n * z + n + folds + folds * small)
              + 4.0 * (folds * params + 3 * folds))
    return Work(2.0 * n * (fwd + bwd), nbytes,
                PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS)


def _bias_like(d: int, hidden: Sequence[int], z: int) -> int:
    """fp32 vector parameters of one modality: biases, cm and lvo."""
    return 2 * sum(hidden) + 2 * z + 2 * d
