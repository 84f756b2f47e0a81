"""Fused decode + deviation: the CUDA kernel and its plain torch version.

``fused_pred_deviation`` replaces the Pallas kernel
``multi_modal_normative_modeling_tpu/kernels/deviation.py::fused_pred_deviation``:
decode concat(z, c) through the decoder MLP and emit both the
reconstruction mean and the per-row deviation sum((x - mean)^2) / D, for
every fold at once (``csrc/pred_deviation.cu``). The Pallas kernel is one
block with no batch tiling; this one tiles rows, so it has no row limit and
needs no fallback. A CUDA tensor goes to the kernel; a CPU tensor goes to
``pred_deviation_reference``.

What bounds the kernel on an H100 is fp32 FFMA, just ahead of the bytes of
x and recon, so its design fills the card: a grid of (32-row tile, column
group of the mean head, fold), column groups only where row tiles x folds
would leave SMs empty (``plan``), each block recomputing the small hidden
chain; sums in registers, weights through a cp.async ring
(``csrc/tile_product.cuh``). With column groups the deviation is summed
from per-group partials in group order: two calls give bit-equal results.
The wrapper keeps what depends only on the layers' identity and the shapes
(the checked chain, the pointer tables, the plan, the scratch) from one
call to the next. The scratch of a shape is shared by its calls, which must
be ordered on one stream, as PyTorch's default stream orders them.

``fused_decoder_mean`` is the same kernel without x and the deviation, and
replaces the Pallas kernel
``multi_modal_normative_modeling_tpu/kernels/mlp.py::fused_decoder_mean``
(the decoder's mean alone; its plain version is ``decode_mean_reference``).

Operands are fold-stacked: z [F, B, Z], c [F, B, C], x [F, B, D], and each
layer a pair (weight [F, out, in], bias [F, out]).
"""
from __future__ import annotations

import collections
import functools
from typing import NamedTuple, Sequence, Tuple

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


class Plan(NamedTuple):
    """How csrc/pred_deviation.cu runs one shape: a grid of (tiles, groups,
    folds); group q walks the mean head's 128-wide column chunks q,
    q + groups, ... Scratch (floats) is used with groups > 1 and a
    deviation: folds * tiles tickets, then the partials [groups, F, B]."""
    tiles: int
    chunks: int
    groups: int
    scratch: int
    smem: int

    @property
    def blocks(self) -> int:
        """Per fold."""
        return self.tiles * self.groups


@functools.lru_cache(maxsize=64)
def plan(folds: int, rows: int, k_in: int, hidden: Tuple[int, ...],
         d: int) -> Plan:
    """The launch plan of one shape (``hidden`` the hidden layers' output
    widths in order, ``k_in`` the width of [z | c]); pure Python, the same
    for the same shape."""
    tiles = -(-rows // _build.TILE_ROWS)
    chunks = -(-d // _build.TILE_COLS)
    # the hidden chain, which every group repeats, in units of one column
    # chunk of the mean head
    mac, k = 0, k_in
    for n in hidden:
        mac, k = mac + k * n, n
    groups = _build.fill_split(tiles * folds, chunks,
                               unit=mac / (k * _build.TILE_COLS))
    scratch = folds * tiles + groups * folds * rows if groups > 1 else 0
    return Plan(tiles, chunks, groups, scratch,
                _build.pred_deviation_smem(max(k_in, *hidden, 1)))


# what the last calls' layers and shapes came to: (ctypes tables, plan,
# scratch), by the layers' addresses and the operands' shapes
_CACHED_CALLS = 16
_calls: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()


def _prepare(name, layers, n_hidden, z, c, x):
    """Checks the chain and the shapes and builds what a launch needs
    beside the batch; kept per (layers, shapes)."""
    folds, rows, z_dim = z.shape
    c_dim = _build.check_rows(name, "c", c, folds, rows)
    _build.check_tensors(name, [t for layer in layers for t in layer],
                         z.device)
    widths = _build.chain_widths(name, layers, z_dim + c_dim, n_hidden, folds)
    d = widths[-1]
    if x is not None and _build.check_rows(name, "x", x, folds, rows) != d:
        raise ValueError(f"{name}: mean head width {d} != x width "
                         f"{x.shape[2]}")
    p = plan(folds, rows, z_dim + c_dim, tuple(widths[:n_hidden]), d)
    if p.smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"{name}: hidden widths {widths[:n_hidden]} need "
                         f"{p.smem} B of shared memory, over the "
                         f"{_build.MAX_SMEM_BYTES} B limit")
    # the tickets start zero and every launch leaves them zero
    scratch = (torch.zeros(p.scratch, device=z.device)
               if x is not None and p.scratch else None)
    return _build.launch_args(layers, widths), d, p, scratch


def _launch(name, hidden, mean_head, z, c, x, non_linear):
    """One launch of csrc/pred_deviation.cu; x None: the mean alone."""
    if z.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {z.device}")
    layers = [*hidden, mean_head]
    if z.dim() != 3:
        raise ValueError(f"{name}: z must be [F, B, Z], got {tuple(z.shape)}")
    batch = [z, c] if x is None else [z, c, x]
    _build.check_tensors(name, batch, z.device)
    key = (tuple((w.data_ptr(), b.data_ptr(), w.shape, b.shape, w.dtype,
                  b.dtype, w.is_contiguous(), b.is_contiguous())
                 for w, b in layers),
           tuple(t.shape for t in batch), z.device)
    found = _calls.get(key)
    if found is None:
        found = _prepare(name, layers, len(hidden), z, c, x)
        _calls[key] = found
        if len(_calls) > _CACHED_CALLS:
            _calls.popitem(last=False)
    else:
        _calls.move_to_end(key)
    (w, b, n), d, p, scratch = found
    folds, rows, z_dim = z.shape
    recon = torch.empty(folds, rows, d, device=z.device)
    dev = None if x is None else torch.empty(folds, rows, device=z.device)
    if rows == 0:
        return recon, dev
    lib = _build.load_library()
    with _build.current_device_guard(z.device):
        rc = lib.mmnm_pred_deviation(
            z.data_ptr(), c.data_ptr(), None if x is None else x.data_ptr(),
            recon.data_ptr(), None if dev is None else dev.data_ptr(),
            None if scratch is None else scratch.data_ptr(), folds, rows,
            z_dim, c.shape[2], d, len(hidden), w, b, n, int(non_linear),
            p.groups, _build.stream_of(z.device))
    _build.check_launch(lib, rc, name)
    return recon, dev
