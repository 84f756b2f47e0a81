"""The inference kernels K1, K2 and K3 as PyTorch custom operators.

``mmnm::fused_encoder`` (K1, ``mlp.py``), ``mmnm::fused_pred_deviation``
(K2, ``deviation.py``) and ``mmnm::fused_decoder_mean`` (K3, a mode of K2's
source) are operators of a ``torch.library.Library`` (``define``, ``impl``,
``register_fake``) with three implementations each:

  * CUDA: the launch code of the kernel (its plan cache, scratch, the
    current stream, ``check_launch`` and the ``launches`` counter);
  * CPU: the plain torch version (``encoder_reference``,
    ``pred_deviation_reference``, ``decode_mean_reference``);
  * fake (``register_fake``): the output shapes alone, so that
    ``torch.export`` traces an op with a symbolic batch into one opaque
    ``mmnm::*`` node and none of the launch code's host planning
    specialises the batch.

Tensors on any other device raise: the dispatcher finds no implementation
for them, and the meta device, which the fake implementation answers,
raises there. The wrappers ``mlp.fused_encoder``,
``deviation.fused_pred_deviation`` and ``deviation.fused_decoder_mean`` call
these operators, so a CUDA tensor has exactly one way to a kernel and none
to a plain version. A layer chain goes in as one flat list, weight then
bias per layer (weights [F, out, in], biases [F, out]): the hidden layers,
then the heads. The operators are registered when the ``kernels`` package
is imported; a process that loads an exported scoring program needs that
import and nothing else of the port.

K4 to K6 are training kernels behind ``autograd.Function``s and stay plain
Python calls. (``torch.library.custom_op`` would wrap each implementation
in a dynamo-disabling decorator whose first call imports ``torch._dynamo``:
about 10 us more a call, and an import that probes for optional packages
the scoring path never needs. The operators here are the dispatcher's own,
with no autograd formula: a backward through one raises.)
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import Tensor

from . import deviation, mlp


def _shapes_only(kernel: str, t: Tensor) -> None:
    """The fake implementation also answers the meta device, which has no
    kernel and no plain version: a real meta tensor raises (a fake tensor
    reports the device it stands for)."""
    if t.device.type == "meta":
        raise ValueError(f"{kernel}: no kernel for {t.device}")


def _pairs(layers: List[Tensor]):
    if len(layers) % 2:
        raise ValueError(f"a layer list holds weight, bias pairs; got "
                         f"{len(layers)} tensors")
    return [(layers[i], layers[i + 1]) for i in range(0, len(layers), 2)]


_LIB = torch.library.Library("mmnm", "DEF")
_LIB.define("fused_encoder(Tensor x, Tensor c, Tensor[] layers, "
            "int n_hidden, bool non_linear, int? splits=None) "
            "-> (Tensor, Tensor)")
_LIB.define("fused_pred_deviation(Tensor z, Tensor c, Tensor x, "
            "Tensor[] layers, bool non_linear) -> (Tensor, Tensor)")
_LIB.define("fused_decoder_mean(Tensor z, Tensor c, Tensor[] layers, "
            "bool non_linear) -> Tensor")


def _register(name: str, cuda, cpu, fake) -> None:
    _LIB.impl(name, cuda, "CUDA")
    _LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"mmnm::{name}", fake, lib=_LIB)


# ---- K1 -------------------------------------------------------------------
def _encoder_cuda(x: Tensor, c: Tensor, layers: List[Tensor], n_hidden: int,
                  non_linear: bool, splits: Optional[int] = None
                  ) -> Tuple[Tensor, Tensor]:
    """(mu, logvar) [F, B, Z] of [x | c] through ``n_hidden`` hidden layers
    and the two heads: the kernel."""
    return mlp.launch(x, c, _pairs(layers), n_hidden, non_linear, splits)


def _encoder_cpu(x, c, layers, n_hidden, non_linear, splits=None):
    pairs = _pairs(layers)
    return mlp.encoder_reference(pairs[:n_hidden], pairs[n_hidden],
                                 pairs[n_hidden + 1], x, c, non_linear)


def _encoder_fake(x, c, layers, n_hidden, non_linear, splits=None):
    _shapes_only("fused_encoder", x)
    shape = (x.shape[0], x.shape[1], layers[2 * n_hidden].shape[1])
    return x.new_empty(shape), x.new_empty(shape)


_register("fused_encoder", _encoder_cuda, _encoder_cpu, _encoder_fake)


# ---- K2 -------------------------------------------------------------------
def _pred_deviation_cuda(z: Tensor, c: Tensor, x: Tensor,
                         layers: List[Tensor], non_linear: bool
                         ) -> Tuple[Tensor, Tensor]:
    """(mean [F, B, D], deviation [F, B]) of [z | c] through the hidden
    layers and the mean head: the kernel."""
    return deviation.launch_pred_deviation(z, c, x, _pairs(layers),
                                           non_linear)


def _pred_deviation_cpu(z, c, x, layers, non_linear):
    pairs = _pairs(layers)
    return deviation.pred_deviation_reference(pairs[:-1], pairs[-1], z, c, x,
                                              non_linear)


def _pred_deviation_fake(z, c, x, layers, non_linear):
    _shapes_only("fused_pred_deviation", z)
    return (z.new_empty((z.shape[0], z.shape[1], layers[-1].shape[-1])),
            z.new_empty((z.shape[0], z.shape[1])))


_register("fused_pred_deviation", _pred_deviation_cuda, _pred_deviation_cpu,
          _pred_deviation_fake)


# ---- K3 -------------------------------------------------------------------
def _decoder_mean_cuda(z: Tensor, c: Tensor, layers: List[Tensor],
                       non_linear: bool) -> Tensor:
    """The mean [F, B, D] of [z | c] through the hidden layers and the mean
    head: the kernel."""
    return deviation.launch_decoder_mean(z, c, _pairs(layers), non_linear)


def _decoder_mean_cpu(z, c, layers, non_linear):
    pairs = _pairs(layers)
    return deviation.decode_mean_reference(pairs[:-1], pairs[-1], z, c,
                                           non_linear)


def _decoder_mean_fake(z, c, layers, non_linear):
    _shapes_only("fused_decoder_mean", z)
    return z.new_empty((z.shape[0], z.shape[1], layers[-1].shape[-1]))


_register("fused_decoder_mean", _decoder_mean_cuda, _decoder_mean_cpu,
          _decoder_mean_fake)

OPS = ("mmnm::fused_encoder", "mmnm::fused_pred_deviation",
       "mmnm::fused_decoder_mean")
