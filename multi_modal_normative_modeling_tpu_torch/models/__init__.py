"""Model zoo of the port: the reference's registry names
(multimodal_kfold_train_cvae_supervised.py:150-157), and the two models
that only their own CLIs build: the end-to-end nm-PM-cont model
(``EndToEndCVAE``, cli/nmpmcont.py) and the FI regression
(``RegressionCVAE``, cli/regression.py)."""

from .cvae import Classifier, Decoder, Encoder, reparameterize  # noqa: F401
from .dmvae import DMVAEFamily  # noqa: F401
from .endtoend import EndToEndCVAE  # noqa: F401
from .multimodal import MultimodalCVAE  # noqa: F401
from .regression import RegressionCVAE  # noqa: F401

# registry name -> (family, variant)
REGISTRY = {
    "cVAE_multimodal": (MultimodalCVAE, "cvae"),
    "mmJSD": (MultimodalCVAE, "mmjsd"),
    "mvtCAE": (MultimodalCVAE, "mvtcae"),
    "DMVAE": (DMVAEFamily, "dmvae"),
    "WeightedDMVAE": (DMVAEFamily, "weighted"),
    "mmVAEPlus": (DMVAEFamily, "mmvaeplus"),
}


def build_model(name: str, input_dim_list, hidden_dim, latent_dim, c_dim,
                modalities: int, non_linear: bool = True, folds: int = 1,
                generator=None, device=None):
    """Construct a model by its reference registry name, holding ``folds``
    folds' parameters."""
    if name not in REGISTRY:
        raise ValueError(
            f"Model '{name}' is not recognized. Available models are: "
            "cVAE_multimodal, mmJSD, DMVAE, WeightedDMVAE, mvtCAE, mmVAEPlus")
    family, variant = REGISTRY[name]
    if family is DMVAEFamily:
        return DMVAEFamily(input_dim_list, hidden_dim, latent_dim, c_dim,
                           modalities, variant=variant, folds=folds,
                           generator=generator, device=device)
    return MultimodalCVAE(input_dim_list, hidden_dim, latent_dim, c_dim,
                          modalities, non_linear, variant=variant,
                          folds=folds, generator=generator, device=device)
