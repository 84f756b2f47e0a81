"""Training on the split-latent packed layout of the DMVAE family
(counterpart of train/grouped_dmvae.py).

``PackedMultiFoldTrainer`` with the layout swapped for
models/grouped_dmvae.GroupedDMVAE. Each step draws the noise of the shared
code at the model's ``noise_dim`` (latent_dim - c_dim, zero when the shared
code is empty), as the per-modality trainer does. The family always fuses
by PoE (``combine`` is ignored, as in the per-modality model) and trains in
fp32 (``packed_supported`` refuses bf16).
"""
from __future__ import annotations

from ..models.grouped_dmvae import GroupedDMVAE
from .packed import DMVAE_FAMILY, PackedMultiFoldTrainer


class GroupedDMVAEMultiFoldTrainer(PackedMultiFoldTrainer):
    """Every fold at once on the split-latent grouped layout."""

    def _build_layout(self, model):
        if getattr(model, "variant", None) not in DMVAE_FAMILY:
            raise ValueError(
                f"split-latent grouped layout supports the DMVAE family "
                f"(dmvae/weighted/mmvaeplus), got "
                f"{getattr(model, 'variant', None)!r}")
        return GroupedDMVAE(model.input_dim_list, model.hidden_dim,
                            model.latent_dim, model.c_dim, model.modalities,
                            variant=model.variant)

    def _loss_name(self) -> str:
        return f"packed_grouped_{self.layout.variant}"

    def _loss(self, packed, batch, eps):
        fwd = self.layout.forward(packed, batch["x"], eps)
        losses = self.layout.loss(packed, batch["x"], fwd, batch["mask"])
        return losses["total"], losses
