"""Fused conditional encoder: the CUDA kernel and its plain torch version.

``fused_encoder`` replaces the Pallas kernel
``multi_modal_normative_modeling_tpu/kernels/mlp.py::fused_encoder``: the
whole concat(x, c) -> hidden linears (+LeakyReLU) -> mu/logvar chain in one
launch, for every fold at once (``csrc/encoder.cu``). The wrapper calls the
custom operator ``mmnm::fused_encoder`` (``ops.py``), whose CUDA
implementation is ``launch`` and whose CPU implementation is
``encoder_reference``.

What bounds the kernel on an H100 is fp32 FFMA, nearly all of it in the
first layer, whose reduction is as long as the input is wide. The grid is
(32-row tile, K split, fold): a block holds its slice of [x | c] in shared
memory and multiplies it against the same columns of the first layer's
weights (``csrc/tile_product.cuh``); ``plan`` splits the reduction where
row tiles x folds would leave SMs empty, and so that two blocks share an
SM. With splits the raw partial sums go to scratch and the last block of a
(row tile, fold) to arrive adds them in split order and runs the rest of
the chain, its two heads in one pass straight from the last activation
tile: two calls give bit-equal results. The wrapper keeps what
depends only on the layers' identity and the shapes (the checked chain, the
pointer tables, the plan, the scratch) from one call to the next. The
scratch of a shape is shared by its calls, which must be ordered on one
stream, as PyTorch's default stream orders them.

Operands are fold-stacked: x [F, B, D], c [F, B, C], and each layer a pair
(weight [F, out, in], bias [F, out]).
"""
from __future__ import annotations

import collections
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

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


class Plan(NamedTuple):
    """How csrc/encoder.cu runs one shape: a grid of (tiles, splits, folds);
    split s reduces columns [s k_per, (s + 1) k_per) of [x | c]. Scratch
    (floats) is used with splits > 1: folds * tiles tickets, then the
    partials [splits, F, B, N0], N0 the first hidden width (2 Z without a
    hidden layer)."""
    tiles: int
    chunks: int
    splits: int
    k_per: int
    scratch: int
    smem: int


@functools.lru_cache(maxsize=64)
def plan(folds: int, rows: int, k_in: int, hidden: Tuple[int, ...], z: int,
         splits: Optional[int] = None) -> Plan:
    """The launch plan of one shape (``hidden`` the hidden layers' output
    widths in order, ``k_in`` the width of [x | c]); pure Python, the same
    for the same shape. ``splits`` forces the number of K splits (tests and
    measurements); by default the fewest block-times over waves of two
    blocks an SM, with slices small enough for two blocks to share one."""
    depth, cols = _build.TILE_DEPTH, _build.TILE_COLS
    tiles = -(-rows // _build.TILE_ROWS)
    chunks = -(-k_in // depth)
    widest = max(hidden, default=1)
    if splits is None:
        # the most chunks whose slice leaves room for a second block
        most = max((n for n in range(1, chunks + 1)
                    if _build.encoder_smem(n * depth, widest)
                    <= _build.HALF_SM_SMEM_BYTES), default=1)
        # the rest of the chain, which the last block of a (tile, fold)
        # walks alone, in steps of the first layer's loop
        first = -(-hidden[0] // cols) if hidden else 2 * -(-z // cols)
        rest = sum(-(-k // depth) * -(-n // cols)
                   for k, n in zip(hidden, hidden[1:]))
        if hidden:
            rest += 2 * -(-hidden[-1] // depth) * -(-z // cols)
        splits = _build.fill_split(tiles * folds, chunks, unit=rest / first,
                                   least=-(-chunks // most))
    elif not 1 <= splits <= chunks:
        raise ValueError(f"fused_encoder: {splits} splits of {chunks} chunks")
    per = -(-chunks // splits)
    splits = -(-chunks // per)            # every split holds a column
    n0 = hidden[0] if hidden else 2 * z
    scratch = folds * tiles + splits * folds * rows * n0 if splits > 1 else 0
    return Plan(tiles, chunks, splits, per * depth, scratch,
                _build.encoder_smem(per * depth, widest))


# what the last calls' layers and shapes came to: (ctypes tables, widths,
# plan, scratch), by the layers' addresses and the operands' shapes
_CACHED_CALLS = 16
_calls: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()


def _prepare(name, layers, n_hidden, x, c, splits):
    """Checks the chain and the shapes and builds what a launch needs
    beside the batch; kept per (layers, shapes)."""
    folds, rows, d = x.shape
    c_dim = _build.check_rows(name, "c", c, folds, rows)
    _build.check_tensors(name, [t for layer in layers for t in layer],
                         x.device)
    widths = _build.chain_widths(name, layers, d + c_dim, n_hidden, folds)
    z_dim = widths[-1]
    if widths[-2] != z_dim:
        raise ValueError(f"{name}: mu head width {widths[-2]} != logvar "
                         f"head width {z_dim}")
    p = plan(folds, rows, d + c_dim, tuple(widths[:n_hidden]), z_dim, splits)
    if p.smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"{name}: hidden widths {widths[:n_hidden]} with "
                         f"slices of {p.k_per} input columns need {p.smem} B "
                         f"of shared memory, over the "
                         f"{_build.MAX_SMEM_BYTES} B limit")
    # the tickets start zero and every launch leaves them zero
    scratch = torch.zeros(p.scratch, device=x.device) if p.scratch else None
    return _build.launch_args(layers, widths), z_dim, p, scratch


def fused_encoder(hidden: Sequence[Layer], mu_head: Layer, lv_head: Layer,
                  x: torch.Tensor, c: torch.Tensor, non_linear: bool,
                  splits: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (mu, logvar), each [F, B, Z], through the custom operator
    ``mmnm::fused_encoder`` (``ops.py``): the kernel for CUDA tensors, its
    plain version for CPU tensors. ``splits`` forces the plan's K splits
    (tests and measurements)."""
    layers = [t for layer in (*hidden, mu_head, lv_head) for t in layer]
    return torch.ops.mmnm.fused_encoder(x, c, layers, len(hidden),
                                        non_linear, splits)


def launch(x: torch.Tensor, c: torch.Tensor, layers: Sequence[Layer],
           n_hidden: int, non_linear: bool, splits: Optional[int] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of csrc/encoder.cu: the CUDA implementation of
    ``mmnm::fused_encoder``. ``layers`` are the hidden layers, then the mu
    and logvar heads."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_encoder: no kernel for {x.device}")
    name = "fused_encoder"
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be [F, B, D], got {tuple(x.shape)}")
    _build.check_tensors(name, [x, c], x.device)
    key = (tuple((w.data_ptr(), b.data_ptr(), w.shape, b.shape, w.dtype,
                  b.dtype, w.is_contiguous(), b.is_contiguous())
                 for w, b in layers),
           x.shape, c.shape, x.device, splits)
    found = _calls.get(key)
    if found is None:
        found = _prepare(name, layers, n_hidden, x, c, splits)
        _calls[key] = found
        if len(_calls) > _CACHED_CALLS:
            _calls.popitem(last=False)
    else:
        _calls.move_to_end(key)
    (w, b, n), z_dim, p, scratch = found
    folds, rows, d = x.shape
    mu = torch.empty(folds, rows, z_dim, device=x.device)
    lv = torch.empty(folds, rows, z_dim, device=x.device)
    if rows == 0:
        return mu, lv
    lib = _build.load_library()
    with _build.current_device_guard(x.device):
        rc = lib.mmnm_encoder(
            x.data_ptr(), c.data_ptr(), mu.data_ptr(), lv.data_ptr(),
            None if scratch is None else scratch.data_ptr(), folds, rows, d,
            c.shape[2], z_dim, n_hidden, w, b, n, int(non_linear),
            p.splits, p.k_per, _build.stream_of(x.device))
    _build.check_launch(lib, rc, name)
    fused_encoder.launches += 1
    return mu, lv


fused_encoder.launches = 0
