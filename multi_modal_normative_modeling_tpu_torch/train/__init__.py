"""Training of the fold-stacked cVAE: config, batching, losses, the masked
Adam, the epoch loop and the checkpoint writer."""

from .checkpoints import checkpoint_exists, save_checkpoint  # noqa: F401
from .trainer import (  # noqa: F401
    TrainConfig,
    default_loss_fn,
    make_batches,
    resolve_loss,
)
