"""multi_modal_normative_modeling_tpu_torch — the PyTorch/CUDA port of
``multi_modal_normative_modeling_tpu``.

The JAX package stays the reference; this package mirrors its layout and
module names so each counterpart is easy to find:

  ops/        - linear layers, latent-fusion ops and loss terms (plain torch)
  models/     - the conditional encoder/decoder, MultimodalCVAE (cvae,
                mmjsd, mvtcae, nmmlp) and the DMVAE family; build_model
  kernels/    - hand-written CUDA kernels (sm_90a) with plain torch versions
  train/      - training config, batching, the masked Adam, the epoch loop,
                the one-fold library trainer and the checkpoints
  parallel/   - fold stacking and the fold-parallel trainer
  interop.py  - JAX param trees <-> torch modules, flax msgpack checkpoints
  registry.py - dataset, modality and label tables
  data/       - CSV ingestion, scaling, covariate binning, synthetic cohorts
  infer/      - deviation math and the deviation CSV emitters
  evaluation/ - deviation-to-classification metrics (numpy, no scikit-learn)
                and the report writers
  utils/      - loss logs, plots, the JSONL run log
  viz.py      - the side notebooks' tables and figures
  demo.py     - the notebooks' synthetic demo projects
  cli/        - the k-fold train stage, test stage (deviation scoring) and
                analysis stage, the three in one process (pipeline), and
                the early-fusion table writer

Weights are stored as ``[fan_out, fan_in]`` with a leading fold axis
(``[F, fan_out, fan_in]``): every fold of a k-fold run trains in one step
and is scored by one kernel launch per modality. Only ``interop``
transposes to the JAX ``[fan_in, fan_out]`` layout.

The package never imports jax, nor the JAX package. Importing it imports nothing heavy:
attribute access pulls the submodule on demand. The facade resolves every
public name of the JAX package's facade to the port's counterpart, and
``params_from_jax``, ``params_to_jax`` and ``read_flax_checkpoint`` besides.
"""

__version__ = "0.1.0"

_PUBLIC_API = {
    # model zoo (the JAX facade's names, each to the port's counterpart)
    "build_model": "models",
    "MultimodalCVAE": "models",
    "DMVAEFamily": "models",
    # training engines + checkpoints
    "TrainConfig": "train",
    "FoldTrainer": "train",
    "train_single_fold": "train",
    "make_batches": "train",
    "save_checkpoint": "train",
    "load_checkpoint": "train",
    "checkpoint_exists": "train",
    # fold-parallel / mesh scale-out
    "MultiFoldTrainer": "parallel",
    "make_mesh": "parallel",
    "make_mesh3": "parallel",
    "stack_params": "parallel",
    "stack_fold_batches": "parallel",
    # deviation math
    "reconstruction_deviation": "infer.deviation",
    "reconstruction_deviation_roi": "infer.deviation",
    "latent_deviation": "infer.deviation",
    "separate_latent_deviation": "infer.deviation",
    "latent_pvalues": "infer.deviation",
    "DeviationEmitter": "infer.emitters",
    # fold-ensemble scoring of new subjects
    "load_ensemble": "infer.ensemble",
    "EnsembleState": "infer.ensemble",
    # dataset/procedure registry
    "get_datasets_name": "registry",
    "get_column_name": "registry",
    "get_hc_label": "registry",
    # the port's own: JAX param trees and checkpoints <-> torch modules
    "params_from_jax": "interop",
    "params_to_jax": "interop",
    "read_flax_checkpoint": "interop",
}

_SUBMODULES = ("cli", "data", "evaluation", "infer", "interop", "kernels",
               "models", "native", "ops", "parallel", "registry", "train",
               "utils", "viz")

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
