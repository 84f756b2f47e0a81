"""The modality axis of a packed layout split over ranks (expert
parallelism, parallel/modality.py).

Inside ``modality_shard(shard)`` a packed layout (models/stacked.py,
models/grouped.py, models/grouped_endtoend.py) computes each product on the
modalities its rank holds: a leaf's modality axis of length n is split over
the 'modality' ranks when their count divides n (``split``), and the layout
takes this rank's part of an activation before a product of split leaves
(``part``) and the whole activation back after it (``whole``, an
all_gather). A whole value is alike on every rank, and where it enters a
rank's own products (``part``, ``vary``) the backward sums the ranks'
cotangents (parallel/modality.py's docstring). Outside the context every
call is the identity, so the unmeshed layouts compute what they always
did.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch

_SHARD = None


@contextlib.contextmanager
def modality_shard(shard):
    """Split the packed layouts' modality axes by ``shard``
    (parallel.modality.ModalityShard; None: no split)."""
    global _SHARD
    outer, _SHARD = _SHARD, shard
    try:
        yield
    finally:
        _SHARD = outer


def split(n: int) -> bool:
    """Whether a modality axis of length ``n`` is split over the ranks."""
    return _SHARD is not None and _SHARD.splits(n)


def span(n: int) -> Tuple[int, int]:
    """This rank's [lo, hi) of a modality axis of length ``n``."""
    return _SHARD.span(n) if split(n) else (0, n)


def part(t: torch.Tensor, n: int, dim: int = 1) -> torch.Tensor:
    """This rank's part of ``t`` along ``dim``, a modality axis of length
    ``n`` (``t`` as it is when it holds the part already)."""
    if not split(n) or t.shape[dim] != n:
        return t
    lo, hi = span(n)
    return _SHARD.vary(t).narrow(dim, lo, hi - lo)


def vary(t: torch.Tensor) -> torch.Tensor:
    """``t``, alike on every rank, entering this rank's own products."""
    return t if _SHARD is None else _SHARD.vary(t)


def whole(t: torch.Tensor, n: int, dim: int = 1) -> torch.Tensor:
    """The whole ``t`` along ``dim`` from every rank's part of a modality
    axis of length ``n``."""
    if not split(n) or t.shape[dim] == n:
        return t
    return _SHARD.gather(t, dim)
