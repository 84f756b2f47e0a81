"""Fused decode + deviation: the CUDA kernel and its plain torch version.

``fused_pred_deviation`` replaces the Pallas kernel
``multi_modal_normative_modeling_tpu/kernels/deviation.py::fused_pred_deviation``:
decode concat(z, c) through the decoder MLP and emit both the
reconstruction mean and the per-row deviation sum((x - mean)^2) / D, for
every fold at once (``csrc/pred_deviation.cu``). The Pallas kernel is one
block with no batch tiling; this one tiles rows, so it has no row limit and
needs no fallback. A CUDA tensor goes to the kernel; a CPU tensor goes to
``pred_deviation_reference``.

``fused_decoder_mean`` is the same kernel without x and the deviation, and
replaces the Pallas kernel
``multi_modal_normative_modeling_tpu/kernels/mlp.py::fused_decoder_mean``
(the decoder's mean alone; its plain version is ``decode_mean_reference``).

Operands are fold-stacked: z [F, B, Z], c [F, B, C], x [F, B, D], and each
layer a pair (weight [F, out, in], bias [F, out]).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..ops.linear import apply_hidden, apply_linear
from . import _build
from ._build import Layer


def decode_mean_reference(hidden: Sequence[Layer], mean_head: Layer,
                          z: torch.Tensor, c: torch.Tensor,
                          non_linear: bool) -> torch.Tensor:
    """The decoder's reconstruction mean (models.cvae.apply_decoder)."""
    h = apply_hidden(hidden, torch.cat([z, c], dim=-1), non_linear)
    return apply_linear(*mean_head, h)


def reconstruction_deviation(x: torch.Tensor,
                             x_pred: torch.Tensor) -> torch.Tensor:
    """Per-subject mean squared error over features (cVAE.py:1210-1211)."""
    return torch.sum((x - x_pred) ** 2, dim=-1) / x.shape[-1]


def pred_deviation_reference(hidden: Sequence[Layer], mean_head: Layer,
                             z: torch.Tensor, c: torch.Tensor,
                             x: torch.Tensor, non_linear: bool
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the kernel."""
    mean = decode_mean_reference(hidden, mean_head, z, c, non_linear)
    return mean, reconstruction_deviation(x, mean)


def fused_pred_deviation(hidden: Sequence[Layer], mean_head: Layer,
                         z: torch.Tensor, c: torch.Tensor, x: torch.Tensor,
                         non_linear: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (reconstruction [F, B, D], deviation [F, B])."""
    if z.device.type == "cpu":
        return pred_deviation_reference(hidden, mean_head, z, c, x,
                                        non_linear)
    out = _launch("fused_pred_deviation", hidden, mean_head, z, c, x,
                  non_linear)
    fused_pred_deviation.launches += 1
    return out


fused_pred_deviation.launches = 0


def fused_decoder_mean(hidden: Sequence[Layer], mean_head: Layer,
                       z: torch.Tensor, c: torch.Tensor,
                       non_linear: bool) -> torch.Tensor:
    """Returns the reconstruction mean [F, B, D]."""
    if z.device.type == "cpu":
        return decode_mean_reference(hidden, mean_head, z, c, non_linear)
    recon, _ = _launch("fused_decoder_mean", hidden, mean_head, z, c, None,
                       non_linear)
    fused_decoder_mean.launches += 1
    return recon


fused_decoder_mean.launches = 0


def _launch(name, hidden, mean_head, z, c, x, non_linear):
    """One launch of csrc/pred_deviation.cu; x None: the mean alone."""
    if z.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {z.device}")
    layers = [*hidden, mean_head]
    if z.dim() != 3:
        raise ValueError(f"{name}: z must be [F, B, Z], got {tuple(z.shape)}")
    folds, rows, z_dim = z.shape
    c_dim = _build.check_rows(name, "c", c, folds, rows)
    batch = [z, c] if x is None else [z, c, x]
    _build.check_tensors(name, [*batch, *[t for layer in layers
                                          for t in layer]], z.device)
    widths = _build.chain_widths(name, layers, z_dim + c_dim, len(hidden),
                                 folds)
    d = widths[-1]
    if x is not None and _build.check_rows(name, "x", x, folds, rows) != d:
        raise ValueError(f"{name}: mean head width {d} != x width "
                         f"{x.shape[2]}")
    recon = torch.empty(folds, rows, d, device=z.device)
    dev = None if x is None else torch.empty(folds, rows, device=z.device)
    if rows == 0:
        return recon, dev
    lib = _build.load_library()
    w, b, n = _build.launch_args(layers, widths)
    with torch.cuda.device(z.device):
        rc = lib.mmnm_pred_deviation(
            z.data_ptr(), c.data_ptr(), None if x is None else x.data_ptr(),
            recon.data_ptr(), None if dev is None else dev.data_ptr(), folds,
            rows, z_dim, c_dim, d, len(hidden), w, b, n, int(non_linear),
            _build.stream_of(z.device))
    _build.check_launch(lib, rc, name)
    return recon, dev
