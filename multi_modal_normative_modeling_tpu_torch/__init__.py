"""multi_modal_normative_modeling_tpu_torch — the PyTorch/CUDA port of
``multi_modal_normative_modeling_tpu``.

The JAX package stays the reference; this package mirrors its layout and
module names so each counterpart is easy to find:

  ops/        - linear layers, latent-fusion ops and loss terms (plain torch)
  models/     - the conditional encoder/decoder and MultimodalCVAE
  kernels/    - hand-written CUDA kernels (sm_90a) with plain torch versions
  train/      - training config, batching, the masked Adam, the epoch loop
                and the checkpoint writer
  parallel/   - fold stacking and the fold-parallel trainer
  interop.py  - JAX param trees <-> torch modules, flax msgpack checkpoints
  cli/        - the k-fold train stage and test stage (deviation scoring)

Weights are stored as ``[fan_out, fan_in]`` with a leading fold axis
(``[F, fan_out, fan_in]``): every fold of a k-fold run trains in one step
and is scored by one kernel launch per modality. Only ``interop``
transposes to the JAX ``[fan_in, fan_out]`` layout.

The package never imports jax. Importing it imports nothing heavy:
attribute access pulls the submodule on demand.
"""

__version__ = "0.1.0"

_PUBLIC_API = {
    "build_model": "models",
    "MultimodalCVAE": "models",
    "stack_params": "parallel",
    "params_from_jax": "interop",
    "params_to_jax": "interop",
    "read_flax_checkpoint": "interop",
    "MultiFoldTrainer": "parallel",
    "TrainConfig": "train",
}

_SUBMODULES = ("cli", "interop", "kernels", "models", "ops", "parallel",
               "train")

__all__ = sorted(_PUBLIC_API) + list(_SUBMODULES)


def __getattr__(name):
    import importlib

    if name in _PUBLIC_API:
        module = importlib.import_module(f".{_PUBLIC_API[name]}", __name__)
        value = getattr(module, name)
        globals()[name] = value
        return value
    if name in _SUBMODULES:
        module = importlib.import_module(f".{name}", __name__)
        globals()[name] = module
        return module
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
