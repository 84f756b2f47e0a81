"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
torch version.

Kernel inventory:
  * mlp.py       — ``fused_encoder`` (csrc/encoder.cu): the conditional
                   encoder chain for every fold in one launch.
  * deviation.py — ``fused_pred_deviation`` (csrc/pred_deviation.cu): decode
                   plus per-row deviation for every fold in one launch.

A wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors; ``<wrapper>.launches`` counts the kernel's launches.
Importing this package compiles nothing: the library builds on first launch
(``_build.py``).
"""

from .deviation import (  # noqa: F401
    fused_pred_deviation,
    pred_deviation_reference,
    reconstruction_deviation,
)
from .mlp import encoder_reference, fused_encoder  # noqa: F401

KERNELS = (fused_encoder, fused_pred_deviation)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0
