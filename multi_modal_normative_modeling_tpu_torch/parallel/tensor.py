"""Tensor parallelism over a 'model' mesh axis (counterpart of
parallel/tensor.py).

The JAX package annotates the weights with ``PartitionSpec``s and lets
GSPMD place the collectives. The port decides the same split per layer
(``module_plan``, as parallel/tensor.py:64-155 does) and writes the
collectives out in the Megatron pattern:

  hidden layer 0, 2, ... : column-parallel, the rank holds rows
                           [k N/nm, (k+1) N/nm) of the [F, N, K] weight and
                           of the bias; its input passes through
                           ``copy_to_model`` (identity forward, all_reduce
                           of the gradient backward); the activation comes
                           out feature-sharded
  hidden layer 1, 3, ... : row-parallel, the rank holds columns of the
                           weight; ``reduce_from_model`` sums the partial
                           products (all_reduce forward, identity backward),
                           then the whole bias is added
  mu/logvar/mean heads   : row-parallel when their input is sharded, else
                           replicated; logvar_out, alpha and the rest stay
                           replicated.

A layer is split only where its dimension divides by the 'model' size, and
one that does not breaks the alternation (its output is replicated). The
port stores weights [F, out, in] (interop.py), so a column split is on
``out`` (dim 1) and a row split on ``in`` (dim 2). A bare
``dist.all_reduce`` inside a forward would leave autograd's gradient of the
replicated input wrong without an error; the two autograd functions are
what keeps it right.

The split applies to the cVAE skeleton's ``Encoder`` and ``Decoder``
modules (cVAE_multimodal, mmJSD, mvtCAE). ``shard_model_`` splits a
fold-stacked model in place; ``unshard_model_`` gathers the whole weights
back before a checkpoint is written.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..ops.linear import apply_linear, leaky_relu
from .mesh import Mesh, ShardPlan, build_mesh, fold_data_shardings
from . import distributed


def make_mesh3(n_fold: int = 1, n_data: int = 1,
               n_model: Optional[int] = None, device="cpu") -> Mesh:
    """A ('fold', 'data', 'model') mesh over the run's ranks
    (parallel/tensor.py:42-58); ``n_model`` defaults to filling the
    remaining ranks."""
    world = distributed.world_size()
    if n_model is None:
        if world % (n_fold * n_data):
            raise ValueError(f"{world} devices not divisible by fold*data "
                             f"{n_fold}x{n_data}")
        n_model = world // (n_fold * n_data)
    if n_fold * n_data * n_model != world:
        raise ValueError(
            f"mesh {n_fold}x{n_data}x{n_model} != {world} devices")
    return build_mesh({"fold": n_fold, "data": n_data, "model": n_model},
                      device)


class ModulePlan(NamedTuple):
    """The split of one encoder or decoder: ``hidden`` one of 'col', 'row'
    or None per hidden layer, ``head`` 'row' or None for its heads."""
    hidden: Tuple[Optional[str], ...]
    head: Optional[str]


def mlp_plan(shapes: Sequence[Tuple[int, int]], n_model: int
             ) -> Tuple[Tuple[Optional[str], ...], bool]:
    """(kinds, whether the stack's output is feature-sharded) of a hidden
    stack of (fan_in, fan_out) layers (parallel/tensor.py:91-114)."""
    kinds: List[Optional[str]] = []
    sharded = False
    for fan_in, fan_out in shapes:
        if n_model > 1 and not sharded and fan_out % n_model == 0:
            kinds.append("col")
            sharded = True
        elif n_model > 1 and sharded and fan_in % n_model == 0:
            kinds.append("row")
            sharded = False
        else:
            kinds.append(None)
            sharded = False
    return tuple(kinds), sharded


def head_plan(fan_in: int, sharded: bool, n_model: int) -> Optional[str]:
    """A head is row-parallel iff its input is sharded
    (parallel/tensor.py:116-121)."""
    if n_model > 1 and sharded and fan_in % n_model == 0:
        return "row"
    if sharded:
        raise ValueError("a head on a sharded activation that does not "
                         "divide over the 'model' axis")
    return None


def _fold_linear_shape(layer) -> Tuple[int, int]:
    out, fan_in = layer.weight.shape[-2:]
    return int(fan_in), int(out)


def module_plan(module, n_model: int) -> ModulePlan:
    """The plan of an ``Encoder`` or ``Decoder``."""
    kinds, sharded = mlp_plan([_fold_linear_shape(layer)
                               for layer in module.hidden], n_model)
    head = module.mu if hasattr(module, "mu") else module.mean
    return ModulePlan(kinds, head_plan(_fold_linear_shape(head)[0], sharded,
                                       n_model))


def tp_modules(model) -> List[Tuple[str, torch.nn.Module]]:
    """(name, module) of every encoder and decoder the plan splits."""
    from ..models.cvae import Decoder, Encoder

    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, (Encoder, Decoder))]


def tp_param_specs(model, n_model: int) -> Dict[str, Optional[int]]:
    """{parameter name: the dim split over 'model', or None}: the port's
    ``tp_param_specs`` (parallel/tensor.py:150-155) on the [F, out, in]
    layout; a column split is dim 1 of the weight and the bias, a row split
    dim 2 of the weight."""
    split: Dict[str, Optional[int]] = {name: None
                                       for name, _ in model.named_parameters()}
    for prefix, module in tp_modules(model):
        plan = module_plan(module, n_model)
        heads = ["mu", "logvar"] if hasattr(module, "mu") else ["mean"]
        layers = [(f"hidden.{i}", kind) for i, kind in enumerate(plan.hidden)]
        layers += [(h, plan.head) for h in heads]
        for layer, kind in layers:
            base = f"{prefix}.{layer}" if prefix else layer
            if kind == "col":
                split[f"{base}.weight"] = 1
                split[f"{base}.bias"] = 1
            elif kind == "row":
                split[f"{base}.weight"] = 2
    return split


def tp_supported(model) -> Optional[str]:
    """Why ``model`` cannot take a 'model' axis, or None."""
    if not tp_modules(model):
        return (f"{type(model).__name__} has no encoder/decoder stack the "
                "tensor-parallel plan splits (the cVAE skeleton only)")
    return None


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all_reduce of the gradient over 'model' backward:
    the input of a column-parallel layer."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        return ctx.mesh.all_reduce_(grad, "model"), None


class _ReduceFromModel(torch.autograd.Function):
    """all_reduce over 'model' forward, identity backward: the partial
    products of a row-parallel layer."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce_(x.contiguous().clone(), "model")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh)


class TensorParallel:
    """The forward of one split encoder or decoder (``Encoder.tp`` /
    ``Decoder.tp``)."""

    def __init__(self, plan: ModulePlan, mesh: Mesh):
        self.plan = plan
        self.mesh = mesh

    def linear(self, kind: Optional[str], layer, h: torch.Tensor
               ) -> torch.Tensor:
        weight, bias = layer
        if kind == "col":
            return apply_linear(weight, bias, copy_to_model(h, self.mesh))
        if kind == "row":
            return (reduce_from_model(h @ weight.mT, self.mesh)
                    + bias.unsqueeze(-2))
        return apply_linear(weight, bias, h)

    def hidden(self, layers, h: torch.Tensor, non_linear: bool
               ) -> torch.Tensor:
        for kind, layer in zip(self.plan.hidden, layers):
            h = self.linear(kind, layer, h)
            if non_linear:
                h = leaky_relu(h)
        return h

    def encoder(self, enc, x: torch.Tensor, c: torch.Tensor):
        h = self.hidden(enc.hidden_layers(), torch.cat([x, c], dim=-1),
                        enc.non_linear)
        return (self.linear(self.plan.head, enc.mu.pair(), h),
                self.linear(self.plan.head, enc.logvar.pair(), h))

    def decoder(self, dec, z: torch.Tensor, c: torch.Tensor):
        h = self.hidden(dec.hidden_layers(), torch.cat([z, c], dim=-1),
                        dec.non_linear)
        return self.linear(self.plan.head, dec.mean.pair(), h), dec.logvar_out


def split_range(size: int, mesh: Mesh) -> Tuple[int, int]:
    """This rank's [start, stop) of a dimension split over 'model'."""
    per = size // mesh.axis("model")
    k = mesh.index("model")
    return k * per, (k + 1) * per


def attach_(model, mesh: Mesh) -> None:
    """Give every split module its ``TensorParallel`` forward."""
    for _, module in tp_modules(model):
        module.tp = TensorParallel(module_plan(module, mesh.axis("model")),
                                   mesh)


def detach_(model) -> None:
    for _, module in tp_modules(model):
        module.tp = None


def fold_model_shardings(mesh: Mesh, n_folds: int, batch_rows: int
                         ) -> ShardPlan:
    """The plan for the fold-parallel trainer over a ('fold'[, 'data'][,
    'model']) mesh (parallel/tensor.py:158-189): folds over 'fold', batch
    rows over 'data', the weight matrices over 'model' (``tensor=True``).
    The drop-in alternative to ``mesh.fold_data_shardings``."""
    return fold_data_shardings(mesh, n_folds, batch_rows)._replace(
        tensor=True)
