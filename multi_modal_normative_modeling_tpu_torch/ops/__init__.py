"""Plain torch building blocks: fold-stacked linears, latent fusion and the
loss terms."""

from . import fusion, losses  # noqa: F401
from .linear import (  # noqa: F401
    FoldLinear,
    apply_hidden,
    apply_linear,
    init_linear,
    leaky_relu,
)
