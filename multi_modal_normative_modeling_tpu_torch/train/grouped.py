"""Training on the pad-free width-grouped layout, and the ``--packed_xla``
routing (counterpart of train/grouped.py).

``GroupedMultiFoldTrainer`` is ``PackedMultiFoldTrainer`` with the padded
layout swapped for models/grouped.GroupedStackedCVAE: the hidden chains
stay one batched product over every modality, the width-dependent products
run per width group at exact width. ``select_packed_trainer`` is the one
owner of the layout choice: mixed-width cvae-skeleton cohorts go to the
grouped layout, uniform widths to the padded one (the two are the same
there), the DMVAE family to its split-latent layout.

The port keeps one whole-run train state per run, under the JAX package's
layout names (``packed_state_dirname``): a state of one layout is never
opened by another, and ``notice_stale_padded_state`` says so when a
mixed-width cohort's padded state is left over.
"""
from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from ..models.grouped import GroupedStackedCVAE, width_groups
from .packed import (
    DMVAE_FAMILY,
    SKELETON,
    PackedMultiFoldTrainer,
    _pack_fold_batches,
)


def make_grouped_fold_batches(grouped, data_list: Sequence[np.ndarray],
                              cov: np.ndarray, batch_size: int) -> dict:
    """One fold's per-modality arrays -> {x: one [NB, G, B, d] per width
    group, c [NB, B, C], mask [NB, B], valid [NB]}
    (train/grouped.py:31-58), numpy."""
    return _pack_fold_batches(grouped, data_list, cov, batch_size)


class GroupedMultiFoldTrainer(PackedMultiFoldTrainer):
    """Every fold at once on the width-grouped layout."""

    def _build_layout(self, model):
        if getattr(model, "variant", None) not in SKELETON:
            raise ValueError(
                f"grouped layout supports the cvae skeleton "
                f"(cvae/mmjsd/mvtcae/nmmlp), got "
                f"{getattr(model, 'variant', None)!r}")
        return GroupedStackedCVAE(
            model.input_dim_list, model.hidden_dim, model.latent_dim,
            model.c_dim, model.modalities, model.non_linear,
            variant=model.variant,
            jsd_on_fused=getattr(model, "jsd_on_fused", True))

    def _loss_name(self) -> str:
        v = self.layout.variant
        return "packed_grouped" if v == "cvae" else f"packed_grouped_{v}"

    def _x(self, batch):
        return batch["x"]


def grouped_routing(model) -> bool:
    """Whether ``--packed_xla`` takes the grouped layout for ``model``: a
    cvae-skeleton model over more than one distinct modality width."""
    return (getattr(model, "variant", None) in SKELETON
            and len(width_groups(model.input_dim_list)) > 1)


def select_packed_trainer(model):
    """The ``--packed_xla`` layout of ``model``: (trainer class, layout
    name, layout tag), the tag one of 'padded', 'grouped', 'dmvae'
    (train/grouped.py:155-180; the port has one trainer per layout, which
    trains every fold at once)."""
    if getattr(model, "variant", None) in DMVAE_FAMILY:
        from .grouped_dmvae import GroupedDMVAEMultiFoldTrainer

        return GroupedDMVAEMultiFoldTrainer, "split-latent grouped", "dmvae"
    if grouped_routing(model):
        return GroupedMultiFoldTrainer, "width-grouped", "grouped"
    return PackedMultiFoldTrainer, "packed", "padded"


def packed_state_dirname(layout) -> str:
    """The whole-run train-state directory of a layout tag, the JAX
    package's name for it (without the JAX sequential path's fold
    prefix)."""
    return {"grouped": "grouped-state", "padded": "packed-state",
            "dmvae": "grouped-dmvae-state"}[layout]


def notice_stale_padded_state(state_dir, layout,
                              stale_dirname: str = "packed-state",
                              new_dirname: str = "grouped-state") -> None:
    """A mixed-width cohort's padded-layout state left from before the
    grouped routing is never opened by the grouped layout; say so, in the
    JAX package's words (train/grouped.py:183-212). The expert-parallel
    states have their own names (ep-packed-state, ep-grouped-state)."""
    if layout != "grouped":
        return
    stale = Path(state_dir) / stale_dirname
    if stale.exists():
        print(
            f'note: leftover padded-layout resume state at {stale} — this '
            'mixed-width cohort now routes to the width-grouped layout '
            f'(state dir {new_dirname!r}), whose numerics differ, so training '
            '(re)starts from the grouped state; the padded state is '
            'ignored and can be deleted')
