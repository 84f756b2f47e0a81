"""Process-group start-up of the port (counterpart of parallel/distributed.py).

The JAX package drives all of a host's devices from one process and wraps
``jax.distributed.initialize`` for several hosts. The port runs one process
per mesh slot: a rank is the port's device. ``python -m
torch.distributed.run --nproc_per_node N`` (torchrun) starts the ranks and
sets ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``, which take the place of the JAX
package's ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
``JAX_PROCESS_ID``. Without ``WORLD_SIZE`` the world is one rank and no
process group is made: ``--mesh 1,1`` then runs as the unmeshed run does.

The backend is NCCL where every rank of a host has a card of its own, and
gloo otherwise (the CPU, or ranks sharing one card: NCCL refuses two ranks on
one GPU). Nothing switches backend after a failure.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def world_size() -> int:
    """Ranks in the run: the process group's, else ``WORLD_SIZE``, else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def local_world_size() -> int:
    """Ranks on this host (``LOCAL_WORLD_SIZE``; the whole world when it is
    not set): the role of the JAX package's local device count."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", str(world_size())))


def rank_device(device) -> torch.device:
    """This rank's device of the type of ``device``: ``cuda:{LOCAL_RANK %
    cards}`` (ranks share a card when there are more ranks than cards), or
    the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def choose_backend(device) -> str:
    """NCCL where every rank on the host has a card of its own, else gloo."""
    device = torch.device(device)
    if (device.type == "cuda"
            and torch.cuda.device_count() >= local_world_size()):
        return "nccl"
    return "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cpu") -> Optional[str]:
    """Join the process group from the arguments (``coordinator_address``
    host:port, or an init URL such as ``file:///path``, a store no port can
    be raced for) or torchrun's variables (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); a world of one rank makes
    no group. Returns the backend, or None without a group.
    Calling it again in a process that has joined does nothing."""
    if dist.is_initialized():
        return dist.get_backend()
    n = int(num_processes if num_processes is not None
            else os.environ.get("WORLD_SIZE", "1"))
    if n <= 1:
        return None
    # env:// reads MASTER_ADDR/MASTER_PORT, and under torchrun joins the
    # store its agent keeps there
    init = "env://"
    if coordinator_address is not None:
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
    me = int(process_id if process_id is not None
             else os.environ.get("RANK", "0"))
    backend = choose_backend(device)
    if backend == "nccl":
        torch.cuda.set_device(rank_device(device))
    dist.init_process_group(backend, init_method=init, world_size=n,
                            rank=me)
    return backend


def shutdown() -> None:
    """Wait for every rank, then leave the process group (if any)."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def fold_axis_size(n_folds: int, world: int, local: int) -> int:
    """The 'fold' axis of ``global_fold_mesh``: the most folds of a
    host-aligned factorisation of ``world`` ranks, ``local`` a host (the
    'data' width divides the host's ranks or is a multiple of them), else
    the largest divisor of the world up to ``n_folds``."""
    local = max(1, local)

    def host_aligned(cand: int) -> bool:
        n_data = world // cand
        return n_data % local == 0 or local % n_data == 0

    candidates = [c for c in range(min(n_folds, world), 0, -1)
                  if world % c == 0]
    return next((c for c in candidates if host_aligned(c)),
                candidates[0] if candidates else 1)


def global_fold_mesh(n_folds: int, device="cpu"):
    """('fold', 'data') mesh over every rank of the run
    (parallel/distributed.py:43-66): a fold's ranks sit on one host when
    the counts allow (``fold_axis_size``)."""
    from .mesh import make_mesh

    return make_mesh(n_fold=fold_axis_size(n_folds, world_size(),
                                           local_world_size()),
                     device=device)
