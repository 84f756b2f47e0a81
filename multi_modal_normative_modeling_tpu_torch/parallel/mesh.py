"""Device meshes of the port (counterpart of parallel/mesh.py).

The JAX package lays its devices out as a ``jax.sharding.Mesh`` ('fold',
'data') and lets GSPMD place the arrays by ``PartitionSpec``. The port runs
one process per mesh slot (``parallel.distributed``): rank r sits at
``np.unravel_index(r, sizes)``, the layout
``torch.distributed.device_mesh.init_device_mesh`` gives the ranks, and each
axis wider than 1 has the process group of the ranks that differ only along
it. What GSPMD's specs decide the port writes out as plans:

  fold   a rank holds folds [i F/nf, (i+1) F/nf) of the fold-stacked model
         and batches (``fold_range``); folds share nothing, so this axis
         needs no collective in training;
  data   a rank holds rows [j B/nd, (j+1) B/nd) of every batch
         (``row_range``); the gradients are summed over the axis;
  model  the weight matrices, split Megatron-style (parallel/tensor.py).

Rule for the backend (``distributed.choose_backend``): NCCL where every rank
of a host has a card of its own, gloo otherwise; on one H100 two ranks share
``cuda:0`` and talk through gloo, which stages a CUDA tensor through the
host. Collectives on CUDA tensors under gloo copy to the host and back here,
explicitly. Nothing switches backend or moves to the CPU after a failure.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import distributed


class Mesh:
    """A mesh of ranks: ``shape`` {axis: size} in axis order, this
    process's ``rank``, its ``coords`` {axis: index}, its ``device`` and the
    process group of each axis wider than 1 (``group``). Built without
    ``device_mesh`` (tests, plans) it has no group, and its collectives are
    only valid on axes of size 1."""

    def __init__(self, shape: Dict[str, int], rank: int = 0, device="cpu",
                 backend: Optional[str] = None, device_mesh=None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = int(np.prod(list(self.shape.values())))
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        index = np.unravel_index(rank, tuple(self.shape.values()))
        self.coords = {name: int(i) for name, i in zip(self.axis_names,
                                                       index)}
        self.device = torch.device(device)
        self.backend = backend
        self.device_mesh = device_mesh

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank}, {self.backend})"

    @property
    def primary(self) -> bool:
        """Rank 0: the one rank that writes files."""
        return self.rank == 0

    def axis(self, name: str) -> int:
        return self.shape.get(name, 1)

    def index(self, name: str) -> int:
        return self.coords.get(name, 0)

    def group(self, name: str):
        """The process group along ``name`` (None for an axis of size 1)."""
        if self.axis(name) <= 1:
            return None
        if self.device_mesh is None:
            raise RuntimeError(f"{self}: axis {name!r} has no process group "
                               "(a plan-only mesh)")
        return self.device_mesh.get_group(name)

    def all_reduce_(self, tensor: torch.Tensor, name: str) -> torch.Tensor:
        """Sum ``tensor`` in place over the ranks along axis ``name``."""
        group = self.group(name)
        if group is None:
            return tensor
        if tensor.device.type == "cuda" and self.backend == "gloo":
            host = tensor.detach().cpu()
            dist.all_reduce(host, group=group)
            tensor.copy_(host)
        else:
            dist.all_reduce(tensor, group=group)
        return tensor

    def all_reduce_sum(self, tensor: torch.Tensor, name: str
                       ) -> torch.Tensor:
        """The sum of ``tensor`` over the ranks along ``name``, as a
        function autograd differentiates: every rank's loss depends on the
        sum, so its gradient is the sum of the ranks' gradients."""
        if self.axis(name) <= 1:
            return tensor
        return _AllReduceSum.apply(tensor, self, name)

    def all_gather_cat(self, tensor: torch.Tensor, name: str, dim: int = 1
                       ) -> torch.Tensor:
        """Every rank's ``tensor`` along axis ``name``, concatenated on
        ``dim`` in the axis's order: a value every rank of the axis holds
        alike, whose cotangent is alike on every rank too, so the backward
        keeps this rank's part of it (JAX's transpose of a tiled
        all_gather into an invariant value)."""
        if self.axis(name) <= 1:
            return tensor
        return _AllGather.apply(tensor, self, name, dim)

    def psum(self, tensor: torch.Tensor, name: str) -> torch.Tensor:
        """The sum of ``tensor`` over the ranks along ``name``, a value
        every rank holds alike: the backward hands its (alike) cotangent to
        each rank's summand unchanged (JAX's psum into an invariant
        value)."""
        if self.axis(name) <= 1:
            return tensor
        return _PSum.apply(tensor, self, name)

    def vary(self, tensor: torch.Tensor, name: str) -> torch.Tensor:
        """``tensor``, alike on every rank along ``name``, entering this
        rank's own computation: the identity forward, and the backward sums
        the ranks' cotangents, each rank's share of the whole (JAX's
        pbroadcast, whose transpose is a psum)."""
        if self.axis(name) <= 1:
            return tensor
        return _Vary.apply(tensor, self, name)

    def all_gather_object(self, obj) -> list:
        """Every rank's ``obj`` (picklable, on the host), in rank order."""
        if self.size == 1:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    """all_reduce forward and backward (Mesh.all_reduce_sum)."""

    @staticmethod
    def forward(ctx, x, mesh, name):
        ctx.mesh, ctx.name = mesh, name
        return mesh.all_reduce_(x.contiguous().clone(), name)

    @staticmethod
    def backward(ctx, grad):
        return (ctx.mesh.all_reduce_(grad.contiguous().clone(), ctx.name),
                None, None)


class _AllGather(torch.autograd.Function):
    """all_gather along ``dim`` forward, this rank's slice backward
    (Mesh.all_gather_cat)."""

    @staticmethod
    def forward(ctx, x, mesh, name, dim):
        ctx.mesh, ctx.name, ctx.dim = mesh, name, dim
        ctx.size = x.shape[dim]
        group = mesh.group(name)
        host = x.detach().contiguous()
        staged = host.device.type == "cuda" and mesh.backend == "gloo"
        if staged:
            host = host.cpu()
        parts = [torch.empty_like(host) for _ in range(mesh.axis(name))]
        dist.all_gather(parts, host, group=group)
        return torch.cat(parts, dim=dim).to(x.device)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.mesh.index(ctx.name) * ctx.size
        return grad.narrow(ctx.dim, lo, ctx.size), None, None, None


class _PSum(torch.autograd.Function):
    """all_reduce forward, identity backward (Mesh.psum)."""

    @staticmethod
    def forward(ctx, x, mesh, name):
        return mesh.all_reduce_(x.contiguous().clone(), name)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _Vary(torch.autograd.Function):
    """identity forward, all_reduce backward (Mesh.vary)."""

    @staticmethod
    def forward(ctx, x, mesh, name):
        ctx.mesh, ctx.name = mesh, name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return (ctx.mesh.all_reduce_(grad.contiguous().clone(), ctx.name),
                None, None)


def build_mesh(shape: Dict[str, int], device="cpu") -> Mesh:
    """A mesh of the running world: ``shape``'s product must equal the
    world size (``distributed.world_size()``; 1 without a process group).
    Joins the process group first (torchrun's variables), then lays the
    ranks out with ``init_device_mesh``."""
    world = distributed.world_size()
    size = int(np.prod(list(shape.values())))
    if size != world:
        raise ValueError(f"mesh {'x'.join(map(str, shape.values()))} != "
                         f"{world} devices")
    backend = distributed.initialize_distributed(device=device)
    rank_device = distributed.rank_device(device)
    if world == 1:
        return Mesh(shape, 0, rank_device, backend)
    from torch.distributed.device_mesh import init_device_mesh

    # the mesh only hands out process groups: "cpu" keeps DeviceMesh from
    # choosing a card for ranks that share one under gloo
    device_mesh = init_device_mesh(
        "cuda" if backend == "nccl" else "cpu", tuple(shape.values()),
        mesh_dim_names=tuple(shape))
    return Mesh(shape, dist.get_rank(), rank_device, backend, device_mesh)


def make_mesh(n_fold: int = 1, n_data: Optional[int] = None,
              device="cpu") -> Mesh:
    """A ('fold', 'data') mesh over the run's ranks (parallel/mesh.py:27-46):
    ``n_fold * n_data`` must equal the world size; ``n_data`` defaults to
    filling the remaining ranks."""
    world = distributed.world_size()
    if n_data is None:
        if world % n_fold:
            raise ValueError(
                f"{world} devices not divisible into {n_fold} fold groups")
        n_data = world // n_fold
    if n_fold * n_data != world:
        raise ValueError(f"mesh {n_fold}x{n_data} != {world} devices")
    return build_mesh({"fold": n_fold, "data": n_data}, device)


def make_sweep_mesh(n_config: int, n_fold: Optional[int] = None,
                    device="cpu") -> Mesh:
    """A ('config', 'fold') mesh for the sweep engine
    (parallel/mesh.py:79-100)."""
    world = distributed.world_size()
    if n_fold is None:
        if world % n_config:
            raise ValueError(f"{world} devices not divisible into "
                             f"{n_config} config groups")
        n_fold = world // n_config
    if n_config * n_fold != world:
        raise ValueError(f"mesh {n_config}x{n_fold} != {world} devices")
    return build_mesh({"config": n_config, "fold": n_fold}, device)


def axis_range(total: int, parts: int, index: int, what: str
               ) -> Tuple[int, int]:
    """The [start, stop) of part ``index`` of ``total`` cut in ``parts``
    equal parts; ``total`` must divide."""
    if total % parts:
        raise ValueError(f"{total} {what} not divisible over {parts} ranks")
    per = total // parts
    return index * per, (index + 1) * per


def fold_range(mesh: Mesh, n_folds: int) -> Tuple[int, int]:
    """The folds this rank holds: P('fold', ...) of a parameter or a batch
    (parallel/mesh.py:49-61)."""
    return axis_range(n_folds, mesh.axis("fold"), mesh.index("fold"),
                      "folds")


def row_range(mesh: Mesh, rows: int) -> Tuple[int, int]:
    """The rows of a batch this rank holds: P('fold', None, 'data') of a
    [F, NB, B, ...] batch leaf."""
    return axis_range(rows, mesh.axis("data"), mesh.index("data"), "rows")


class ShardPlan(NamedTuple):
    """What a rank holds of fold-stacked training: folds [f0, f1) of every
    parameter and batch, rows [r0, r1) of each batch's ``batch_rows``, and
    with ``tensor`` its part of the weights split over 'model'
    (parallel/tensor.py)."""
    folds: Tuple[int, int]
    rows: Tuple[int, int]
    batch_rows: int
    tensor: bool = False


def fold_data_shardings(mesh: Mesh, n_folds: int, batch_rows: int
                        ) -> ShardPlan:
    """The plan for (params, batches, keys) of the fold-parallel trainer
    (parallel/mesh.py:64-76): parameters and noise generators over 'fold',
    batch rows over ('fold', 'data')."""
    return ShardPlan(fold_range(mesh, n_folds), row_range(mesh, batch_rows),
                     batch_rows)


def shard_batches(batches: dict, plan: ShardPlan) -> dict:
    """This rank's part of ``stack_fold_batches`` output ([F, NB, B, ...]):
    its folds and rows of x, c, mask and the extras. ``valid`` [F, NB] keeps
    its global value (a fold steps where any rank has a real row). Where
    the rows are split, ``counts`` [F, NB] holds each batch's global count
    of real rows, the denominator of every masked mean
    (ops.losses.global_row_counts), and ``row_slice`` the rank's rows."""
    f0, f1 = plan.folds
    r0, r1 = plan.rows

    def part(a):
        return np.ascontiguousarray(np.asarray(a)[f0:f1, :, r0:r1])

    mask = np.asarray(batches["mask"])
    out = {
        "x": tuple(part(a) for a in batches["x"]),
        "c": tuple(part(a) for a in batches["c"]),
        "mask": part(mask),
        "valid": np.asarray(batches["valid"])[f0:f1],
    }
    if (r0, r1) != (0, plan.batch_rows):
        out["counts"] = mask[f0:f1].sum(axis=2).astype(np.float32)
        out["row_slice"] = (r0, r1, plan.batch_rows)
    if "extras" in batches:
        out["extras"] = {k: part(v) for k, v in batches["extras"].items()}
    return out


def infer_shards(mesh: Mesh, n_folds: int, rows: int
                 ) -> Tuple[slice, slice]:
    """The (fold, row) slices of a [F, rows, ...] scoring operand this rank
    computes: P('fold', 'data') of the test stage's inputs
    (cli/common.py:643-661)."""
    f0, f1 = fold_range(mesh, n_folds)
    r0, r1 = row_range(mesh, rows)
    return slice(f0, f1), slice(r0, r1)


def gather_fold_rows(mesh: Mesh, local: Sequence[np.ndarray],
                     n_folds: int) -> List[np.ndarray]:
    """Every rank's [F/nf, rows/nd, ...] blocks (one per output) put back
    into the whole [F, rows, ...] arrays, on every rank."""
    pieces = mesh.all_gather_object((mesh.index("fold"), mesh.index("data"),
                                     [np.asarray(a) for a in local]))
    nf, nd = mesh.axis("fold"), mesh.axis("data")
    grid = {(fi, di): arrays for fi, di, arrays in pieces}
    out = []
    for k in range(len(local)):
        out.append(np.concatenate([
            np.concatenate([grid[(fi, di)][k] for di in range(nd)], axis=1)
            for fi in range(nf)], axis=0))
    return out
