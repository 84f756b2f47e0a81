"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
torch version.

Kernel inventory:
  * mlp.py         — ``fused_encoder`` (csrc/encoder.cu): the conditional
                     encoder chain for every fold in one launch.
  * deviation.py   — ``fused_pred_deviation`` (csrc/pred_deviation.cu):
                     decode plus per-row deviation for every fold in one
                     launch; ``fused_decoder_mean``, the same kernel
                     without the deviation.
  * decoder_nll.py — ``decoder_nll`` (csrc/decoder_nll.cu): the decoder's
                     mean head plus the masked Gaussian NLL, forward and
                     backward, for every fold; the ``--fused_decoder``
                     training loss. Both sources sit on
                     csrc/tile_product.cuh: register-tile products over a
                     cp.async ring, launch plans in Python (``plan``).
  * train_step.py  — ``fused_train_step`` (csrc/train_step.cuh, fp32 in
                     train_step.cu): one whole training step (forward and
                     every gradient) of the packed cVAE for every fold;
                     ``--fused_train_step``.
  * train_step_tiled.py — ``tiled_fused_train_step``: the same kernels
                     with fp32 operands or, on the tensor cores, bf16
                     (train_step_bf16.cu), the weight gradients summed over
                     batch tiles; ``--precision bf16``.
  * roofline.py    — each kernel's FLOP, bytes and bound on one H100.

A wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors; ``<wrapper>.launches`` counts the kernel's launches.
Importing this package compiles nothing: the library builds on first launch
(``_build.py``).
"""

from .decoder_nll import (  # noqa: F401
    decoder_nll,
    decoder_nll_reference,
    fused_decoder_loss_fn,
)
from .deviation import (  # noqa: F401
    decode_mean_reference,
    fused_decoder_mean,
    fused_pred_deviation,
    pred_deviation_reference,
    reconstruction_deviation,
)
from .mlp import encoder_reference, fused_encoder  # noqa: F401
from .train_step import FusedTrainStep, fused_train_step  # noqa: F401
from .train_step_tiled import (  # noqa: F401
    TiledFusedTrainStep,
    tiled_fused_train_step,
)

KERNELS = (fused_encoder, fused_pred_deviation, fused_decoder_mean,
           decoder_nll, fused_train_step, tiled_fused_train_step)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0
