"""Training the end-to-end nm-PM-cont model on its packed dual-bank layout
(counterpart of train/packed_endtoend.py).

``PackedMultiFoldTrainer`` with the layout swapped for
models/grouped_endtoend.GroupedEndToEnd: both decoder banks on one [2M]
axis, the width-dependent products per width group. The labels ride the
batches as extras, the classifier head trains in place in the model, and
its BatchNorm running statistics are written back after each step for the
valid folds only (``EndToEndCVAE.update_state``, the JAX ``_bn_update``).
Each step draws its noise and then its dropout keep masks, as the
per-modality trainer does.
"""
from __future__ import annotations

from ..models.grouped_endtoend import GroupedEndToEnd
from .packed import PackedMultiFoldTrainer
from .trainer import TrainConfig


def endtoend_state_dirname() -> str:
    """The packed end-to-end layout's whole-run train-state directory (the
    JAX package's name)."""
    return "grouped-e2e-state"


class GroupedEndToEndTrainer(PackedMultiFoldTrainer):
    """Every fold at once on the packed dual-bank layout. ``margin`` and
    ``weight_contrastive`` shape the gradients, so they join the resume
    fingerprint."""

    def __init__(self, model, config: TrainConfig, n_samples: int,
                 margin: float, weight_contrastive: float, mesh=None,
                 shardings_fn=None):
        self.margin = margin
        self.weight_contrastive = weight_contrastive
        super().__init__(model, config, n_samples, mesh, shardings_fn)
        self.loss_meta.update(margin=str(margin),
                              wcon=str(weight_contrastive))
        self.state_update = model.update_state

    def _build_layout(self, model):
        return GroupedEndToEnd(model.input_dim_list, model.hidden_dim,
                               model.latent_dim, model.c_dim,
                               model.modalities, model.non_linear)

    def _loss_name(self) -> str:
        return "packed_grouped_endtoend"

    def _head(self):
        return self.model.classifier

    def _loss(self, packed, batch, eps):
        labels = batch["extras"]["labels"][..., 0]
        fwd = self.layout.forward(packed, batch["x"], batch["c"], eps,
                                  self.model.classifier, train=True,
                                  mask=batch["mask"], keep=batch.get("keep"))
        losses = self.layout.loss(packed, batch["x"], fwd, labels,
                                  margin=self.margin,
                                  weight_contrastive=self.weight_contrastive,
                                  mask=batch["mask"])
        losses["bn_state"] = fwd["bn_state"]
        return losses["total_loss"], losses
