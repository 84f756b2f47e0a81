"""Plain torch building blocks: fold-stacked linears and latent fusion."""

from . import fusion  # noqa: F401
from .linear import (  # noqa: F401
    FoldLinear,
    apply_hidden,
    apply_linear,
    init_linear,
    leaky_relu,
)
