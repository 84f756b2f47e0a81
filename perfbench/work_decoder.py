"""The yardstick of the fused step's decoder pass (pass 3 of
``csrc/train_step.cuh``): its operations and bytes at a cell's shapes,
by ``perfbench/work.py``'s rules and peaks.

The pass runs, per fold and modality, the decoder's forward on [z | c]
(the reversed hidden layers, then the mean head), the masked Gaussian NLL
and its gradient dmean, and the backward chain back to dz: per forward
product A W the input gradient dY W^T, except into the covariates c, which
have none. The weight gradients are the next pass's work and are not
counted here.

  * FLOP: 2 per multiply-add of those products. Elementwise work (bias,
    LeakyReLU, the NLL) is left out.
  * Bytes: each input read once and each output written once, at 4 bytes a
    value. In: z, c, the row mask and n per fold; x per modality; the
    decoder's weights, biases and output log-variances. Out: what the pass
    hands to the weight-gradient pass and the losses: every hidden
    activation and its gradient dy, dmean, the output log-variance's terms,
    the per-row log-likelihood, dz.
  * Rows: what the data needs, a fold's rows over its steps an epoch (a
    ragged last batch counts its real rows, not the padding the kernel
    also computes).

``route_device_s`` reads a device trace for the kernels of the route
that runs the pass past hidden widths of 440, the wide-hidden route.
"""
from __future__ import annotations

from . import work


def steps_per_epoch(cfg: dict) -> int:
    return -(-cfg["subjects_per_fold"] // cfg["batch_size"])


def mean_rows(cfg: dict) -> float:
    """A fold's rows a step, averaged over an epoch's steps."""
    return cfg["subjects_per_fold"] / steps_per_epoch(cfg)


def decoder_pass_mac(d: int, c: int, hidden, z: int) -> int:
    """Multiply-adds of one row of one modality: the forward mean path and
    its input gradients, less the gradient into c."""
    rev = list(hidden)[::-1]
    forward = work.decoder_mac(d, c, hidden, z)[0]
    return 2 * forward - c * rev[0]


def decoder_pass(cfg: dict, rows: float) -> work.Work:
    """The pass over every fold and modality at ``rows`` rows a fold."""
    dims, c, hidden, z = (list(cfg["input_dim_list"]), cfg["c_dim"],
                          list(cfg["hidden_dim"]), cfg["latent_dim"])
    folds = cfg["folds"]
    flop = 2.0 * folds * rows * sum(decoder_pass_mac(d, c, hidden, z)
                                    for d in dims)
    params = folds * sum(work.decoder_mac(d, c, hidden, z)[1] + d
                         for d in dims)
    per_fold_row = z + c + 1                     # z, c, the row mask
    # x, dmean and the log-variance terms; g and dy of every hidden layer;
    # the row's log-likelihood; dz
    per_row = sum(3 * d + 2 * sum(hidden) + 1 + z for d in dims)
    nbytes = work.F32 * (params + folds
                         + folds * rows * (per_fold_row + per_row))
    return work.Work(flop, nbytes)


def decoder_pass_per_step(cfg: dict) -> work.Work:
    """The pass's work a step, the mean over an epoch's steps."""
    return decoder_pass(cfg, mean_rows(cfg))


# the wide-hidden route's kernels: the one-pass dec_wide_hidden_kernel, or
# the wide route's dec_fwd_, mean_ and dec_bwd_wide_hidden_kernel
ROUTE_KERNEL = "_wide_hidden_kernel<"


def route_device_s(trace):
    """Seconds of device time of the route's kernels in ``trace``
    (devtrace.Trace), or None where none ran."""
    times = [end - start for start, end, name, cat in trace.device
             if cat == "kernel" and ROUTE_KERNEL in name]
    return sum(times) * 1e-6 if times else None
