"""The reference's ``import cVAE`` surface on the port (counterpart of
compat/__init__.py and of the repository root's cVAE.py shim): the
imperative facades of compat/imperative.py and the module-level ops, and a
loud message for the reference's dead classes, which are not ported
(last-definition-wins, SURVEY Q6).

    from multi_modal_normative_modeling_tpu_torch.compat import (
        cVAE_multimodal, DEVICE)
"""
from .imperative import (  # noqa: F401
    DEVICE,
    DMVAE,
    FocalLoss,
    MixtureOfExperts,
    MoPoE,
    Normal,
    ProductOfExperts,
    ProductOfExperts2,
    WeightedDMVAE,
    cVAE_multimodal,
    cVAE_multimodal_endtoend,
    cVAE_multimodal_regression,
    compute_ll,
    mmJSD,
    mmVAEPlus,
    mvtCAE,
)

_EXCLUDED_LEGACY = {
    # reference cVAE.py location -> why it is dead there
    "mmcVAE": ":243 — never instantiated by any live script",
    "cVAE": ":391 — unimodal predecessor, never instantiated",
    "cVAE_multimodal_before_refactor": ":566 — superseded duplicate "
                                       "definition (last-definition-wins)",
    "MVTCAE": ":1046 — empty fusion stub (the winning model is the "
              "lowercase mvtCAE at :1754, which IS exported)",
    "ResidualBlock": ":47 — only used by a dead module-level Sequential "
                     "(:97-99) that no live code touches",
}


def __getattr__(name):  # PEP 562: a loud message for the excluded symbols
    if name in _EXCLUDED_LEGACY:
        raise ImportError(
            f"cVAE.{name} is an excluded legacy symbol (SURVEY Q6): dead "
            f"code in the reference (cVAE.py{_EXCLUDED_LEGACY[name]}) and "
            "intentionally not ported — see the PARITY.md quirk ledger. "
            "Use the winning definitions re-exported by this module "
            "(cVAE_multimodal, mmJSD, mvtCAE, DMVAE, ...) instead.")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
