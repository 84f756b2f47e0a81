"""The yardstick: operations and bytes of a training step, counted from
the cell's shapes, and the H100's published peaks.

A frozen copy of the port's ``kernels/roofline.py`` arithmetic (a later
change to the program may change that file; the benchmark keeps its own),
plus whole-step counts, so that a share stays the same measure when a
kernel is replaced or removed.

Counting rules:
  * FLOP are the matrix products the function needs, 2 per multiply-add.
    Elementwise work (bias, LeakyReLU, fusion, the loss) is left out.
  * Bytes are each input read once and each output written once, at 4
    bytes a value (every cell runs in fp32).
  * A step's backward needs, per forward product A W, the weight gradient
    A^T dY and the input gradient dY W^T, except where no gradient flows to
    A (the batch x and the covariates c).
  * ``model_flops`` of a step is 3 x the forward (the usual count for
    utilization); the roofline counts the backward exactly.

Peaks: NVIDIA's data sheet for the H100 SXM at 700 W, 67 TFLOP/s in fp32
outside the tensor cores (TF32 is off), 3.35 TB/s of device memory.

Pure Python: shapes in, numbers out.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
F32 = 4


@dataclasses.dataclass(frozen=True)
class Work:
    flop: float
    bytes: float

    @property
    def bound_s(self) -> float:
        """The least time the card could take: the larger of the FLOP at
        the fp32 peak and the bytes at the memory's."""
        return max(self.flop / PEAK_FP32_FLOPS, self.bytes / PEAK_BYTES_PER_S)


def chain(k_in: int, widths: Sequence[int]):
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
    mac, params = chain(d + c, hidden)
    return mac + 2 * hidden[-1] * z, params + 2 * (hidden[-1] * z + z)


def decoder_mac(d: int, c: int, hidden: Sequence[int], z: int):
    """(MAC per row, parameters) of one conditional decoder's mean path:
    [z | c] through the reversed hidden layers, then the mean head."""
    rev = list(hidden)[::-1]
    mac, params = chain(z + c, rev)
    return mac + rev[-1] * d, params + rev[-1] * d + d


def model_params(dims: Sequence[int], c: int, hidden: Sequence[int],
                 z: int) -> int:
    """Parameters of one fold: every encoder and decoder, each decoder's
    output log-variance (one a feature) and the gPoE weights (one a
    modality)."""
    total = len(dims)
    for d in dims:
        total += encoder_mac(d, c, hidden, z)[1]
        total += decoder_mac(d, c, hidden, z)[1] + d
    return total


def forward_mac(dims: Sequence[int], c: int, hidden: Sequence[int],
                z: int) -> int:
    """Multiply-adds of one row's forward pass: every encoder, every
    decoder's mean path."""
    return sum(encoder_mac(d, c, hidden, z)[0]
               + decoder_mac(d, c, hidden, z)[0] for d in dims)


def backward_mac(dims: Sequence[int], c: int, hidden: Sequence[int],
                 z: int) -> int:
    """Multiply-adds of one row's backward pass: per forward product the
    weight gradient and the input gradient, less the input gradients that
    no parameter needs (x and c into the first encoder layer, c into the
    first decoder layer)."""
    rev = list(hidden)[::-1]
    return sum(2 * (encoder_mac(d, c, hidden, z)[0]
                    + decoder_mac(d, c, hidden, z)[0])
               - (d + c) * hidden[0] - c * rev[0] for d in dims)


def train_step(cfg: dict) -> Work:
    """One optimizer step of every fold: the forward and backward of
    ``batch_size`` rows a fold, then Adam. In: the batch (x at each
    modality's width, c, the noise, the row mask), the parameters, Adam's
    two moments; out: the losses, the parameters and the two moments.
    The gradients pass from the backward to Adam and are counted once
    written and once read."""
    dims, c, hidden, z = _shape(cfg)
    folds, rows = cfg["folds"], cfg["batch_size"]
    n = folds * rows
    params = folds * model_params(dims, c, hidden, z)
    flop = 2.0 * n * (forward_mac(dims, c, hidden, z)
                      + backward_mac(dims, c, hidden, z))
    batch = n * (sum(dims) + c + z + 1)
    nbytes = F32 * (batch + 3 * folds        # batch in, losses out
                    + 2 * params             # the gradients out and in
                    + 3 * params + 3 * params)  # p, m, v in and out
    return Work(flop, nbytes)


def train_step_model_flops(cfg: dict) -> float:
    """3 x the forward's FLOP of one step of every fold."""
    dims, c, hidden, z = _shape(cfg)
    return 3 * 2.0 * cfg["folds"] * cfg["batch_size"] * forward_mac(
        dims, c, hidden, z)


def _shape(cfg: dict):
    return (list(cfg["input_dim_list"]), cfg["c_dim"], list(cfg["hidden_dim"]),
            cfg["latent_dim"])
