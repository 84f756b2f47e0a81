"""Fused decode + deviation: the CUDA kernel and its plain torch version.

``fused_pred_deviation`` replaces the Pallas kernel
``multi_modal_normative_modeling_tpu/kernels/deviation.py::fused_pred_deviation``:
decode concat(z, c) through the decoder MLP and emit both the
reconstruction mean and the per-row deviation sum((x - mean)^2) / D, for
every fold at once (``csrc/pred_deviation.cu``). The Pallas kernel is one
block with no batch tiling; this one tiles rows, so it has no row limit and
needs no fallback. A CUDA tensor goes to the kernel; a CPU tensor goes to
``pred_deviation_reference``.

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
    if z.device.type != "cuda":
        raise ValueError(f"fused_pred_deviation: no kernel for {z.device}")
    name = "fused_pred_deviation"
    layers = [*hidden, mean_head]
    if z.dim() != 3:
        raise ValueError(f"{name}: z must be [F, B, Z], got {tuple(z.shape)}")
    folds, rows, z_dim = z.shape
    c_dim = _build.check_rows(name, "c", c, folds, rows)
    d = _build.check_rows(name, "x", x, folds, rows)
    _build.check_tensors(name, [z, c, x, *[t for layer in layers
                                           for t in layer]], z.device)
    widths = _build.chain_widths(name, layers, z_dim + c_dim, len(hidden),
                                 folds)
    if widths[-1] != d:
        raise ValueError(f"{name}: mean head width {widths[-1]} != x width "
                         f"{d}")
    recon = torch.empty(folds, rows, d, device=z.device)
    dev = torch.empty(folds, rows, device=z.device)
    if rows == 0:
        return recon, dev
    lib = _build.load_library()
    w, b, n = _build.launch_args(layers, widths)
    with torch.cuda.device(z.device):
        rc = lib.mmnm_pred_deviation(
            z.data_ptr(), c.data_ptr(), x.data_ptr(), recon.data_ptr(),
            dev.data_ptr(), folds, rows, z_dim, c_dim, d, len(hidden), w, b,
            n, int(non_linear), _build.stream_of(z.device))
    _build.check_launch(lib, rc, name)
    fused_pred_deviation.launches += 1
    return recon, dev


fused_pred_deviation.launches = 0
