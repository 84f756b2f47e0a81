"""Model registry of the port. Only ``cVAE_multimodal`` is ported so far."""

from .cvae import Decoder, Encoder, reparameterize  # noqa: F401
from .multimodal import MultimodalCVAE  # noqa: F401

# reference registry names the JAX package builds and the port does not yet
NOT_PORTED = ("mmJSD", "mvtCAE", "DMVAE", "WeightedDMVAE", "mmVAEPlus")


def build_model(name: str, input_dim_list, hidden_dim, latent_dim, c_dim,
                modalities: int, non_linear: bool = True, folds: int = 1,
                generator=None, device=None) -> MultimodalCVAE:
    """Construct a model by its reference registry name, holding ``folds``
    folds' parameters."""
    if name == "cVAE_multimodal":
        return MultimodalCVAE(input_dim_list, hidden_dim, latent_dim, c_dim,
                              modalities, non_linear, variant="cvae",
                              folds=folds, generator=generator, device=device)
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"Model '{name}' is not ported to torch yet; see ROADMAP.md, "
            "queue 1 item 'Zoo'")
    raise ValueError(
        f"Model '{name}' is not recognized. Available models are: "
        "cVAE_multimodal, mmJSD, DMVAE, WeightedDMVAE, mvtCAE, mmVAEPlus")
