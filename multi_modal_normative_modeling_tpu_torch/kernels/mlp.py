"""Fused conditional encoder: the CUDA kernel and its plain torch version.

``fused_encoder`` replaces the Pallas kernel
``multi_modal_normative_modeling_tpu/kernels/mlp.py::fused_encoder``: the
whole concat(x, c) -> hidden linears (+LeakyReLU) -> mu/logvar chain in one
launch, for every fold at once (``csrc/encoder.cu``). A CUDA tensor goes to
the kernel; a CPU tensor goes to ``encoder_reference``.

Operands are fold-stacked: x [F, B, D], c [F, B, C], and each layer a pair
(weight [F, out, in], bias [F, out]).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..ops.linear import apply_hidden, apply_linear
from . import _build
from ._build import Layer


def encoder_reference(hidden: Sequence[Layer], mu_head: Layer,
                      lv_head: Layer, x: torch.Tensor, c: torch.Tensor,
                      non_linear: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the kernel (models.cvae.apply_encoder)."""
    h = apply_hidden(hidden, torch.cat([x, c], dim=-1), non_linear)
    return apply_linear(*mu_head, h), apply_linear(*lv_head, h)


def fused_encoder(hidden: Sequence[Layer], mu_head: Layer, lv_head: Layer,
                  x: torch.Tensor, c: torch.Tensor, non_linear: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (mu, logvar), each [F, B, Z]."""
    if x.device.type == "cpu":
        return encoder_reference(hidden, mu_head, lv_head, x, c, non_linear)
    if x.device.type != "cuda":
        raise ValueError(f"fused_encoder: no kernel for {x.device}")
    name = "fused_encoder"
    layers = [*hidden, mu_head, lv_head]
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be [F, B, D], got {tuple(x.shape)}")
    folds, rows, d = x.shape
    c_dim = _build.check_rows(name, "c", c, folds, rows)
    _build.check_tensors(name, [x, c, *[t for layer in layers
                                        for t in layer]], x.device)
    widths = _build.chain_widths(name, layers, d + c_dim, len(hidden), folds)
    z_dim = widths[-1]
    if widths[-2] != z_dim:
        raise ValueError(f"{name}: mu head width {widths[-2]} != logvar "
                         f"head width {z_dim}")
    mu = torch.empty(folds, rows, z_dim, device=x.device)
    lv = torch.empty(folds, rows, z_dim, device=x.device)
    if rows == 0:
        return mu, lv
    lib = _build.load_library()
    w, b, n = _build.launch_args(layers, widths)
    with torch.cuda.device(x.device):
        rc = lib.mmnm_encoder(
            x.data_ptr(), c.data_ptr(), mu.data_ptr(), lv.data_ptr(),
            folds, rows, d, c_dim, z_dim, len(hidden), w, b, n,
            int(non_linear), _build.stream_of(x.device))
    _build.check_launch(lib, rc, name)
    fused_encoder.launches += 1
    return mu, lv


fused_encoder.launches = 0
