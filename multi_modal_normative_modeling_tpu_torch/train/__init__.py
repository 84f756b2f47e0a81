"""Training of the fold-stacked cVAE: config, batching, losses, the masked
Adam, the epoch loop, the one-fold library trainer and the checkpoints."""

from .checkpoints import (  # noqa: F401
    checkpoint_exists,
    load_checkpoint,
    save_checkpoint,
)
from .trainer import (  # noqa: F401
    FoldTrainer,
    TrainConfig,
    default_loss_fn,
    make_batches,
    resolve_loss,
    train_single_fold,
)
