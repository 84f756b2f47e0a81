"""MaskedAdam's update (K7): the CUDA kernel and its plain torch version.

``train/trainer.py::MaskedAdam`` keeps every parameter of a fold-stacked
model in one flat buffer, each parameter [F, ...] a run of ``numel // F``
elements per fold, fold after fold, and its two moments in two more. A
step updates the folds whose ``valid`` is above zero and leaves the others'
parameters, moments and count as they were.

``masked_adam`` launches ``csrc/masked_adam.cu`` on a CUDA buffer: one pass
that reads g, p, m and v and writes p, m and v once each, bit-equal to the
plain version. ``masked_adam_reference`` is that plain version, the torch
expression MaskedAdam runs on a CPU buffer (held to optax.adam by the CPU
tests) and the card tests hold the kernel against. It replaces no TPU
kernel: the JAX package's Adam is ``optax.adam``, which XLA fuses itself.

``plan`` is the host's part, pure Python: the runs table (one row a
parameter: its offset in the buffer, its per-fold run length, its first
chunk), the chunks the kernel's blocks walk (at most ``CHUNK`` elements,
never across a run, so a chunk has one fold) and the grid.
``masked_adam.launches`` counts the launches.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import _build

CHUNK = 4096        # elements: 256 threads x 4 vectors of 4 floats
# the grid: 256-thread blocks an SM, as many as an SM's 2048 threads hold.
# Its registers let two be resident at once (118 a thread); the other six
# start as those finish, each walking its own chunks (grid-stride)
GRID_BLOCKS_PER_SM = 8


class Plan(NamedTuple):
    runs: Tuple[Tuple[int, int, int], ...]   # (offset, run, first chunk)
    chunks: int
    grid: int


def plan(sizes: Sequence[int], folds: int, chunk: int = CHUNK) -> Plan:
    """The runs table, chunk count and grid of a flat buffer holding
    parameters of ``sizes`` elements, each [folds, ...]."""
    runs = []
    offset = first = 0
    for n in sizes:
        if n % folds:
            raise ValueError(f"masked_adam: a parameter of {n} elements is "
                             f"not [{folds}, ...]")
        run = n // folds
        runs.append((offset, run, first))
        offset += n
        first += folds * -(-run // chunk)
    return Plan(tuple(runs), first, max(1, min(first,
                                               _build.SMS * GRID_BLOCKS_PER_SM)))


def chunk_span(p: Plan, c: int, chunk: int = CHUNK) -> Tuple[int, int, int]:
    """(start, end, fold) of chunk ``c``: the kernel's search and
    arithmetic, on the host."""
    j = max(i for i, row in enumerate(p.runs) if row[2] <= c)
    offset, run, first = p.runs[j]
    pieces = -(-run // chunk)
    fold, piece = divmod(c - first, pieces)
    start = offset + fold * run + piece * chunk
    return start, min(start + chunk, offset + (fold + 1) * run), fold


def fold_index(p: Plan, folds: int) -> np.ndarray:
    """Every element's fold, int64, expanded from the runs table."""
    return np.concatenate([np.zeros(0, np.int64)] + [
        np.repeat(np.arange(folds, dtype=np.int64), run)
        for _, run, _ in p.runs])


def masked_adam_reference(flat, m, v, g, count, valid, lr, fold_of,
                          b1: float, b2: float, eps: float) -> torch.Tensor:
    """One step in place on ``flat``, ``m`` and ``v`` through the element
    fold index ``fold_of``: each per-fold value spread over the elements
    with one ``torch.take``. Returns the new count."""
    count = count + valid

    def spread(per_fold):
        return torch.take(per_fold, fold_of)

    keep = spread(valid) > 0
    m_new = (1.0 - b1) * g + b1 * m
    v_new = (1.0 - b2) * (g * g) + b2 * v
    update = ((m_new / spread(1.0 - b1 ** count))
              / (torch.sqrt(v_new / spread(1.0 - b2 ** count)) + eps))
    flat.copy_(torch.where(keep, flat - spread(lr) * update, flat))
    m.copy_(torch.where(keep, m_new, m))
    v.copy_(torch.where(keep, v_new, v))
    return count


class MaskedAdamKernel:
    """What the kernel's launches share for one flat buffer, checked and
    built once: the buffers' type, device, layout and alignment, and the
    plan's runs table on the device. The buffers are updated in place
    only, so their addresses hold from one step to the next."""

    def __init__(self, flat: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                 p: Plan, folds: int, b1: float, b2: float, eps: float):
        if flat.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"masked_adam: buffer dtype {flat.dtype}, "
                             "expected torch.float32 or torch.float64")
        for t in (m, v):
            if (t.dtype != flat.dtype or t.device != flat.device
                    or t.shape != flat.shape):
                raise ValueError("masked_adam: the moments must match the "
                                 "flat buffer's dtype, device and shape")
        if not all(t.is_contiguous() for t in (flat, m, v)):
            raise ValueError("masked_adam: buffers must be contiguous")
        self.flat, self.m, self.v = flat, m, v
        self.dtype, self.device = flat.dtype, flat.device
        self.index = flat.get_device()
        self.numel = flat.numel()
        self.folds = folds
        # from pinned memory, asynchronously: a pageable upload would wait
        # for the stream (once a job, in the fused trainer's session)
        self.runs = torch.tensor(p.runs, dtype=torch.int64).reshape(-1) \
            .pin_memory().to(flat.device, non_blocking=True)
        self.aligned = all(t.data_ptr() % 16 == 0 for t in (flat, m, v))
        self.buffers = (flat.data_ptr(), m.data_ptr(), v.data_ptr())
        self.shape = (self.runs.data_ptr(), len(p.runs), p.chunks, CHUNK,
                      folds, p.grid, flat.element_size())
        self.scalars = (b1, b2, eps, 1.0 - b1, 1.0 - b2)

    def per_fold(self, t: torch.Tensor, what: str) -> torch.Tensor:
        """``t``, [F] on the buffer's device, as a contiguous tensor of the
        buffer's type: itself, or a copy made on the card (an fp64 buffer
        takes the batches' fp32 ``valid`` exactly). A tensor on another
        device is refused: no step uploads anything."""
        if t.get_device() != self.index or t.numel() != self.folds:
            raise ValueError(f"masked_adam: {what} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"[{self.folds}] on {self.device}")
        if t.dtype is self.dtype and t.is_contiguous():
            return t
        return t.to(self.dtype).reshape(-1).contiguous()

    def launch(self, g: torch.Tensor, count: torch.Tensor,
               valid: torch.Tensor, lr: torch.Tensor) -> torch.Tensor:
        if (g.dtype is not self.dtype or g.get_device() != self.index
                or g.numel() != self.numel):
            raise ValueError(f"masked_adam: gradient {g.dtype} [{g.numel()}] "
                             f"on {g.device}, expected {self.dtype} "
                             f"[{self.numel}] on {self.device}")
        if not g.is_contiguous():
            g = g.contiguous()
        count = self.per_fold(count, "count")
        valid = self.per_fold(valid, "valid")
        lr = self.per_fold(lr, "lr")
        out = torch.empty_like(count)
        g_ptr = g.data_ptr()
        lib = _build.load_library()
        with _build.current_device_guard(self.device):
            rc = lib.mmnm_masked_adam(
                *self.buffers, g_ptr, count.data_ptr(), valid.data_ptr(),
                lr.data_ptr(), out.data_ptr(), *self.shape,
                int(self.aligned and g_ptr % 16 == 0), *self.scalars,
                _build.stream_of(self.device))
        _build.check_launch(lib, rc, "masked_adam")
        return out


def masked_adam(kernel: MaskedAdamKernel, g: torch.Tensor,
                count: torch.Tensor, valid: torch.Tensor,
                lr: torch.Tensor) -> torch.Tensor:
    """One MaskedAdam step on the card, in place on the kernel's buffers.
    Returns the new count. ``launches`` counts the launches."""
    out = kernel.launch(g, count, valid, lr)
    masked_adam.launches += 1
    return out


masked_adam.launches = 0
