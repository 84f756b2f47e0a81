"""Out-of-core streamed training (counterpart of train/streaming.py).

The resident trainer uploads every batch of the run once
(``DeviceBatches``) and steps through them on the device. A cohort whose
batches do not fit beside the model streams instead: the step-major
batches [NB, F, B, ...] are split into S contiguous shards of the batch
axis (``split_shards``: sizes differ by at most one batch), pinned on the
host once per run, and each shard is uploaded while the shard before it
computes.

The design on the card:

* uploads run on a side ``torch.cuda.Stream``: ``non_blocking`` copies
  from pinned memory, so the DMA overlaps the compute stream's kernels.
  Only copies go there, never a kernel: K1, K2 and K4 keep one scratch
  tensor per shape and assume one stream;
* the compute stream waits on a shard's event before its first step, and
  every uploaded tensor is ``record_stream``-ed on the compute stream, so
  when the consumed shard is dropped after its last step the caching
  allocator does not hand its memory out again before the compute stream
  is done with it (the counterpart of JAX's buffer donation);
* ``inflight`` shards at most are on the device at once (2: the one that
  computes and the one that uploads); with S = 1 the one shard stays
  resident across epochs and chunks, as JAX keeps it;
* each shard's device buffer keeps the resident layout's alignment of its
  steps (an offset within a 512-byte block), so every step's slice is the
  resident run's to the byte, and cuBLAS picks the same kernels for it.

``StreamedBatches`` presents ``DeviceBatches``' interface (``step(t)``,
``valid``, ``valid_host``, ``mask``, ``folds``, ``rows``, ``n_batches``,
``fold_rows``), so the epoch loop, ``MaskedAdam``, ``FoldNoise`` and
``TrainSession`` are the resident run's and the op sequence is the same:
the streamed run is bit-equal to ``MultiFoldTrainer`` on the same batches
and noise, and its train state resumes the resident run's and the other
way round (the same ``loss_meta``). ``valid``, ``valid_host`` and the row
mask stay resident: they are a few bytes a row.

On the CPU the shards are plain tensors, copied as they are needed: there
is no side stream to use, and the run is the same run.

With ``mesh`` (a ('fold', 'data') mesh whose 'fold' axis is 1, JAX
train/streaming.py:101-148) each rank streams its rows of every shard and
the gradients are summed over 'data', as ``MultiFoldTrainer`` does on a
mesh: the meshed streamed run is the resident meshed run, bit for bit,
whatever S. Not ported: ``compile()`` (a TPU compile-cache warm-up). The
JAX trainer trains one fold at a time; this one streams the fold-stacked
batches and trains every fold at once, so a shard is [NB_s, F, B, ...].
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..parallel.folds import MultiFoldTrainer
from .trainer import TrainConfig, TrainSession, global_counts

# a shard's device buffer starts at the offset (in elements) its first step
# has in the resident layout, modulo this many bytes
ALIGN_BYTES = 512


def split_shards(batches: dict, shards: int) -> list:
    """Split a make_batches pytree into ``shards`` contiguous sub-pytrees
    along the leading (n_batches) axis (train/streaming.py:64-76). Shard
    sizes differ by at most one batch."""
    nb = batches["mask"].shape[0]
    if not (1 <= shards <= nb):
        raise ValueError(f"shards must be in [1, {nb}] (n_batches), "
                         f"got {shards}")
    bounds = shard_bounds(nb, shards)

    def cut(node, lo, hi):
        if isinstance(node, dict):
            return {k: cut(v, lo, hi) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(cut(v, lo, hi) for v in node)
        if isinstance(node, list):
            return [cut(v, lo, hi) for v in node]
        return node[lo:hi]

    return [cut(batches, lo, hi) for lo, hi in zip(bounds[:-1], bounds[1:])]


def shard_bounds(n_batches: int, shards: int) -> np.ndarray:
    """The S + 1 batch indices that cut NB batches into S shards."""
    return np.linspace(0, n_batches, shards + 1, dtype=int)


def shard_plan(total_batch_bytes: int, hbm_budget_bytes: int) -> int:
    """Smallest shard count keeping ~2 resident shards (double buffer)
    under the budget (train/streaming.py:79-85)."""
    if total_batch_bytes <= 0:
        return 1
    s = max(1, -(-2 * total_batch_bytes // max(hbm_budget_bytes, 1)))
    return int(s)


class StreamedBatches:
    """Stacked batches ([F, NB, B, ...] numpy, as
    parallel.folds.stack_fold_batches builds them) streamed to ``device``
    in ``shards`` contiguous shards of the batch axis, ``inflight`` of them
    on the device at most; the interface of ``DeviceBatches``. A trainer
    calls ``begin(epochs)`` before a chunk of epochs (so that no shard is
    uploaded that the chunk does not consume) and ``end()`` after it."""

    def __init__(self, batches: dict, shards: int, device,
                 dtype=torch.float32, inflight: int = 2):
        device = torch.device(device)
        self.device, self.dtype = device, dtype
        self.inflight = inflight
        self.valid_host = np.asarray(batches["valid"]).T  # [NB, F]
        # each step's row contiguous: MaskedAdam reads it in place
        self.valid = torch.from_numpy(np.ascontiguousarray(
            self.valid_host, dtype=np.float32)).to(device)
        self.mask = self._step_major(batches["mask"]).to(device, dtype)
        self.n_batches, self.folds, self.rows = self.mask.shape
        self.counts, self.row_slice = global_counts(batches, device)
        self.shards = min(shards, self.n_batches)
        self.bounds = shard_bounds(self.n_batches, self.shards)
        self._shard_of = np.repeat(np.arange(self.shards),
                                   np.diff(self.bounds))
        self._cuda = device.type == "cuda"
        # the host side: every leaf step-major, cut into shards; pinned once
        # for the run on the card
        leaves = {f"x{m}": a for m, a in enumerate(batches["x"])}
        leaves.update({f"c{m}": a for m, a in enumerate(batches["c"])})
        leaves.update({f"e:{k}": v
                       for k, v in batches.get("extras", {}).items()})
        self._modalities = len(batches["x"])
        self._extras = list(batches.get("extras", {}))
        self._host: List[Dict[str, torch.Tensor]] = [{} for _ in
                                                     range(self.shards)]
        for name, a in leaves.items():
            a = self._step_major(a)
            for s, (lo, hi) in enumerate(zip(self.bounds[:-1],
                                             self.bounds[1:])):
                part = a[lo:hi]
                if self._cuda:
                    pinned = torch.empty(part.shape, dtype=part.dtype,
                                         pin_memory=True)
                    pinned.copy_(part)
                    part = pinned
                self._host[s][name] = part
        self._side = torch.cuda.Stream(device) if self._cuda else None
        self._dev: Dict[int, Dict[str, torch.Tensor]] = {}
        self._events: Dict[int, torch.cuda.Event] = {}
        self._current: Optional[int] = None
        self._left = 0
        self.uploads = 0   # shards uploaded, for tests and measurements
        self.upload_bytes = 0

    @staticmethod
    def _step_major(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(
            np.swapaxes(np.asarray(a, np.float32), 0, 1)))

    def fold_rows(self) -> List[int]:
        """Each fold's own grid, nb_f * B rows (DeviceBatches.fold_rows)."""
        return [int(n) * self.rows for n in self.valid_host.sum(axis=0)]

    # -- a chunk of epochs --------------------------------------------------
    def begin(self, epochs: int) -> None:
        """The next ``epochs`` epochs are about to be stepped through."""
        self._left = epochs * self.n_batches

    def end(self) -> None:
        """A chunk ended: with more than one shard nothing stays on the
        device (the next chunk starts at shard 0 again); one shard stays
        resident."""
        if self.shards > 1:
            self._dev.clear()
            self._events.clear()
            self._current = None

    # -- the step ------------------------------------------------------------
    def step(self, t: int) -> dict:
        s = int(self._shard_of[t])
        if s != self._current:
            self._enter(s)
        self._left -= 1
        dev = self._dev[s]
        i = t - int(self.bounds[s])
        batch = {"x": [dev[f"x{m}"][i] for m in range(self._modalities)],
                 "c": [dev[f"c{m}"][i] for m in range(self._modalities)],
                 "mask": self.mask[t]}
        if self._extras:
            batch["extras"] = {k: dev[f"e:{k}"][i] for k in self._extras}
        if self.counts is not None:
            batch["counts"] = self.counts[t]
        return batch

    def _enter(self, s: int) -> None:
        """Shard ``s`` takes over: the consumed one is dropped, ``s`` made
        ready for the compute stream, and the shards the chunk consumes
        next are uploaded, ``inflight`` on the device at most."""
        if self._current is not None:
            self._dev.pop(self._current, None)
            self._events.pop(self._current, None)
        self._current = s
        if s not in self._dev:
            self._upload(s)
        if self._cuda:
            torch.cuda.current_stream(self.device).wait_event(
                self._events[s])
        left = self._left - (int(self.bounds[s + 1]) - int(self.bounds[s]))
        nxt = s
        for _ in range(self.inflight - 1):
            if left <= 0:
                break
            nxt = (nxt + 1) % self.shards
            if nxt == s:
                break
            if nxt not in self._dev:
                self._upload(nxt)
            left -= int(self.bounds[nxt + 1]) - int(self.bounds[nxt])

    def _upload(self, s: int) -> None:
        """Shard ``s`` to the device, each leaf into a buffer whose steps
        sit where the resident layout has them modulo ALIGN_BYTES."""
        lo = int(self.bounds[s])
        elem = torch.empty((), dtype=self.dtype).element_size()
        block = ALIGN_BYTES // elem
        out = {}
        if self._cuda:
            compute = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self._side):
                for name, host in self._host[s].items():
                    out[name] = self._placed(host, lo, block)
                    out[name].copy_(host, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._side)
            for dst in out.values():
                dst.record_stream(compute)
            self._events[s] = event
        else:
            for name, host in self._host[s].items():
                out[name] = self._placed(host, lo, block)
                out[name].copy_(host)
        self._dev[s] = out
        self.uploads += 1
        self.upload_bytes += sum(host.numel() * elem
                                 for host in self._host[s].values())

    def _placed(self, host: torch.Tensor, lo: int, block: int
                ) -> torch.Tensor:
        step = int(np.prod(host.shape[1:], dtype=np.int64))
        offset = (lo * step) % block
        buf = torch.empty(host.numel() + block, dtype=self.dtype,
                          device=self.device)
        return buf[offset:offset + host.numel()].view(host.shape)


class StreamingFoldTrainer(MultiFoldTrainer):
    """``MultiFoldTrainer`` (``run``, ``run_milestones``,
    ``run_resumable``, the same arguments) over batches streamed in
    ``shards`` shards, ``inflight`` on the device at once. Its trajectory,
    logs and train state are the resident trainer's bit for bit."""

    def __init__(self, model, config: TrainConfig, n_samples: int,
                 shards: int = 4, loss_fn=None, state_update=None,
                 inflight: int = 2, mesh=None):
        if config.shuffle:
            raise ValueError(
                "StreamingFoldTrainer requires shuffle=False: the per-epoch "
                "permutation spans shard boundaries (use the resident "
                "FoldTrainer, or pre-shuffle rows host-side once)")
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if inflight < 1:
            raise ValueError(f"inflight must be >= 1, got {inflight}")
        if mesh is not None:
            bad = [n for n in mesh.axis_names
                   if n != "data" and mesh.axis(n) != 1]
            if bad:
                raise ValueError(
                    f"streaming composes only with a mesh whose axes other "
                    f"than 'data' are 1; {bad[0]!r} has size "
                    f"{mesh.axis(bad[0])}")
            if config.batch_size % mesh.axis("data"):
                raise ValueError(
                    f"batch_size {config.batch_size} not divisible over the "
                    f"{mesh.axis('data')}-way 'data' mesh axis")
        super().__init__(model, config, n_samples, loss_fn=loss_fn,
                         state_update=state_update, mesh=mesh)
        self.shards = shards
        self.inflight = inflight

    def streamed(self, stacked_batches: dict) -> StreamedBatches:
        """``stack_fold_batches`` output as this trainer streams it."""
        param = next(self.model.parameters())
        return StreamedBatches(stacked_batches, self.shards, param.device,
                               param.dtype, self.inflight)

    def session(self, stacked_batches, **draws) -> TrainSession:
        batches = stacked_batches
        if not isinstance(batches, StreamedBatches):
            batches = self.streamed(self.local_batches(stacked_batches))
        session = super().session(batches, **draws)
        chunk = session.chunk

        def streamed_chunk(first_epoch: int, epochs: int) -> torch.Tensor:
            batches.begin(epochs)
            try:
                return chunk(first_epoch, epochs)
            finally:
                batches.end()

        session.chunk = streamed_chunk
        return session

