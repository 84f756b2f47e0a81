"""Training the FI regression on its width-grouped packed layout
(counterpart of train/packed_regression.py).

``PackedMultiFoldTrainer`` with the layout swapped for
models/grouped_regression.GroupedRegressionCVAE and, alone among the
packed layouts, the reference's per-epoch shuffle: the packed features are
[NB, F, G, B, d], sample axis 3, and ``PackedBatches.permuted`` moves them
on that axis with the same permutation as every other per-sample leaf
(the JAX ``grouped_shuffle_fn``). Each fold permutes its own grid of nb_f
x B rows with its own generator, the permutation the per-modality shuffled
regression draws. The FI score rides the batches as an extra; the
regression head trains in place in the model.
"""
from __future__ import annotations

from ..models.grouped_regression import GroupedRegressionCVAE
from .packed import PackedMultiFoldTrainer


def regression_state_dirname() -> str:
    """The packed regression's whole-run train-state directory (the JAX
    package's name)."""
    return "grouped-reg-state"


class GroupedRegressionTrainer(PackedMultiFoldTrainer):
    """Every fold at once on the packed regression layout (lambda_reg 1.0,
    the reference's)."""

    def _build_layout(self, model):
        return GroupedRegressionCVAE(model.input_dim_list, model.hidden_dim,
                                     model.latent_dim, model.c_dim,
                                     model.modalities, model.non_linear)

    def _loss_name(self) -> str:
        return "packed_grouped_regression"

    def _head(self):
        return self.model.regressor

    def _loss(self, packed, batch, eps):
        fwd = self.layout.forward(packed, batch["x"], batch["c"],
                                  self.config.combine, eps,
                                  self.model.regress)
        losses = self.layout.loss(packed, batch["x"], fwd,
                                  batch["extras"]["fi"][..., 0],
                                  lambda_reg=1.0, mask=batch["mask"])
        return losses["total"], losses
