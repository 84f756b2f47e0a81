"""Supervised multimodal cVAE k-fold training (counterpart of
cli/train_supervised.py).

The same flags and files as the JAX CLI: the k-fold id CSVs, per fold
``NNN/cVAE_model.{ckpt,json}`` (the flax msgpack format, which the JAX and
the port's test stages both read) and ``NNN/Lossestraining.png`` (needs
matplotlib), and ``run_log.jsonl``. Every fold trains at once on one
fold-stacked model (``parallel.MultiFoldTrainer``); the JAX package's
per-fold path and its ``--fold_parallel`` path follow the same trajectory,
so both map onto it. ``--fused_decoder`` runs each modality's mean head and
Gaussian NLL through the ``decoder_nll`` CUDA kernel pair.
``--fused_train_step`` trains every fold at once on the fused train step
(``train.fused.FusedFoldTrainer``: K5 in fp32, K6 with ``--precision
bf16``); where the JAX CLI falls back to its XLA path for a configuration
the fused step does not take, this one exits and says why. ``-Model`` takes
the six registry names (cVAE_multimodal, mmJSD, mvtCAE, DMVAE,
WeightedDMVAE, mmVAEPlus); both fused paths compute cVAE_multimodal's loss
and exit for the other five. ``--checkpoint_every N`` saves a whole-run
train state every N epochs (``train_state.ckpt`` in the model dir; the
fused train step's under ``fused-state/``) and ``--resume`` continues it:
the resumed run's checkpoints equal the uninterrupted run's, byte for byte.
``--in_memory_fusion`` builds a UCA procedure's early-fusion modality from
the scaled base modalities (``common.fuse_preps``) instead of reading its
CSV, on every path.

    python -m multi_modal_normative_modeling_tpu_torch.cli.train_supervised \\
        -R ADNI -P UCA-gPoE -E 200 -K 5 [--fused_decoder] [--device cpu]
        [--fused_train_step [--precision bf16]] [-Model mvtCAE]
        [--checkpoint_every N [--resume]] [--in_memory_fusion]
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import pandas as pd
import torch

from .. import registry
from ..interop import packed_from_model, packed_to_model, params_to_jax
from ..kernels.decoder_nll import fused_decoder_loss_fn
from ..models import REGISTRY, build_model
from ..parallel import MultiFoldTrainer, stack_fold_batches
from ..train import TrainConfig
from ..train.fused import FusedFoldTrainer, supported
from ..utils.logging import RunLog
from . import common

# JAX CLI flags with no port yet: each raises instead of being ignored
_NOT_PORTED_FLAGS = {
    **common.VARIANT_NOT_PORTED,
    'stream_shards': "queue 1 item 'Streaming'",
    'remat': "queue 1 item 'Trainer'",
    'profile_dir': "queue 1 item 'Tooling'",
    'warmup_only': "'Do not port' (a TPU compile-cache warm-up)",
}

EpsFn = Callable[[np.ndarray, int, int, int], np.ndarray]


def default_init(model, name: str = 'cVAE_multimodal') -> None:
    """Every fold starts from the same weights, as the reference re-seeds 42
    per fold (train:119): one fold of the registry model ``name`` drawn from
    torch.Generator seeded 42, repeated over the model's folds."""
    common.init_from_one_fold(model, build_model(
        name, model.input_dim_list, model.hidden_dim, model.latent_dim,
        model.c_dim, model.modalities, getattr(model, 'non_linear', True),
        folds=1, generator=torch.Generator().manual_seed(42)))


def main(args, project_root=None, init_fn: Optional[common.InitFn] = None,
         eps_fn: Optional[EpsFn] = None):
    """``init_fn(model)`` fills the fold-stacked model's initial weights
    (default: ``default_init``). ``eps_fn(valid [F, NB], epochs, batch rows,
    latent dim)`` gives the noise of every step, [epochs * NB, F, rows, Z]
    (tests replay the JAX package's draws; the latent dim is the model's
    ``noise_dim``, the shared code's width for the DMVAE family); by default
    every fold draws from its own generator on the device."""
    common.refuse_not_ported(args, 'trainer', _NOT_PORTED_FLAGS)
    common.require_checkpoint_for_resume(args)
    fused = getattr(args, 'fused_train_step', False)
    precision = getattr(args, 'precision', 'fp32')
    if precision != 'fp32' and not fused:
        raise SystemExit(f'--precision {precision} runs only through the '
                         'fused train step (K6): add --fused_train_step; '
                         'bf16 for the plain trainer is not ported yet, see '
                         "ROADMAP.md, queue 1 item 'Trainer'")
    if fused:
        unsupported = _fused_flag_conflict(args)
        if unsupported:
            raise SystemExit(f'fused train step unavailable ({unsupported})')
    elif getattr(args, 'fused_decoder', False):
        unsupported = _cvae_only(args, 'the decoder_nll kernel pair')
        if unsupported:
            raise SystemExit(f'fused decoder unavailable ({unsupported})')
    device = common.resolve_device(getattr(args, 'device', 'cuda'), 'train')

    project_root = Path(project_root) if project_root else Path.cwd()
    model_name = 'supervised_cvae'
    kfold_dir = project_root / 'outputs' / 'kfold_analysis'
    model_dir = kfold_dir / model_name
    model_dir.mkdir(parents=True, exist_ok=True)

    np.random.seed(42)

    dataset_names = registry.get_datasets_name(args.dataset_resourse,
                                               args.procedure)
    participants_path = project_root / 'data' / args.dataset_resourse / 'y.csv'
    ids_df = pd.read_csv(participants_path)
    hc_label = registry.get_hc_label(args.dataset_resourse)
    training_class_label = hc_label if args.training_class == 'nm' else 0
    common.generate_kfold_ids(ids_df[ids_df['DIA'] == training_class_label],
                              ids_df[ids_df['DIA'] != training_class_label],
                              oversample_percentage=args.oversample_percentage,
                              n_splits=args.n_splits,
                              project_root=project_root)

    run_log = RunLog(model_dir / 'run_log.jsonl')
    run_log.event('train_start', args=vars(args))

    n_folds = args.n_splits
    folds, input_dim_list, c_dim = common.prepare_folds(
        args, project_root, kfold_dir, model_dir, dataset_names,
        participants_path)
    config_dict = common.model_config_dict(args, input_dim_list, c_dim,
                                           len(dataset_names))
    batch_size = getattr(args, 'batch_size', None)
    batch_size = 256 if batch_size is None else int(batch_size)
    if batch_size < 1:
        raise SystemExit(f'--batch_size must be >= 1, got {batch_size}')
    train_config = TrainConfig(
        epochs=args.epochs,
        batch_size=batch_size,
        learning_rate=0.0001,
        combine=args.combine,
        lr_schedule=getattr(args, 'lr_schedule', 'constant'),
        base_lr=args.base_learning_rate,
        max_lr=args.max_learning_rate,
        seed=42,
        precision=precision,
    )

    model = common.build_model_from_config(config_dict, folds=n_folds)
    if fused:
        ok, reason = supported(model, train_config)
        if ok:
            reason = common.uniform_covariates(folds)
            ok = reason is None
        if not ok:
            raise SystemExit(f'fused train step unavailable ({reason})')
    if init_fn is not None:
        init_fn(model)
    else:
        default_init(model, config_dict['model'])
    model.to(device)
    max_n = max(f[0][0].shape[0] for f in folds)
    resumable = common.Resumable(args)
    if fused:
        # its own state dir: the padded packed layout
        logs, steps, run_s = _train_fused(model, train_config, folds, max_n,
                                          device, eps_fn, resumable,
                                          model_dir / 'fused-state')
    else:
        # the whole-run state in the model dir, as the JAX CLI's
        # fold-parallel path keeps it
        logs, steps, run_s = _train(args, model, train_config, folds, max_n,
                                    eps_fn, resumable, model_dir)
    per_fold_logs = [{k: v[f] for k, v in logs.items()}
                     for f in range(n_folds)]
    per_fold_params = [params_to_jax(model, fold=f) for f in range(n_folds)]
    common.emit_fold_artifacts(model_dir, per_fold_logs, per_fold_params,
                               config_dict, n_folds)
    # fold_done only after the fold's artifacts are on disk
    for fold in range(n_folds):
        last = {k: float(v[-1]) for k, v in per_fold_logs[fold].items()}
        print('Train fold:', fold, ' final-epoch ',
              ', '.join(f'{k}: {round(v, 3)}' for k, v in last.items()))
        run_log.event('fold_done', fold=fold, **last)
        print('fold_model_dir:', model_dir / f'{fold:03d}')
    # the trainer's run alone: batches to the device, every step this call
    # ran (a resumed run's from its stored epoch), the logs' fetch at the end
    run_log.event('train_end', folds=n_folds, steps=steps, run_s=run_s,
                  **resumable.fields())


def _cvae_only(args, what: str) -> Optional[str]:
    """Why a path that computes cVAE_multimodal's loss cannot train
    ``args.model``, or None."""
    name = getattr(args, 'model', 'cVAE_multimodal')
    if name == 'cVAE_multimodal' or name not in REGISTRY:
        return None  # an unknown name is build_model's to refuse
    return (f'model {name!r}: {what} computes the cVAE_multimodal loss '
            'only, as in the JAX package, which falls back to its plain '
            'loss here; this CLI exits instead (ROADMAP.md, "Stated '
            'divergences"). Train this model without the flag')


def _fused_flag_conflict(args) -> Optional[str]:
    """Why --fused_train_step cannot run with these flags (checked before
    any file is written), or None."""
    unsupported = _cvae_only(args, 'the fused train step')
    if unsupported:
        return unsupported
    combine = (getattr(args, 'combine', None)
               or getattr(args, 'procedure', 'UCA-gPoE').split('-')[1])
    if combine.lower() not in ('poe', 'gpoe', 'moe', 'mopoe'):
        return f'fusion {combine!r}'
    if getattr(args, 'fused_decoder', False):
        return ('--fused_decoder is mutually exclusive with '
                '--fused_train_step')
    return None


def _train_fused(model, train_config, folds, max_n, device, eps_fn,
                 resumable: common.Resumable, state_dir: Path):
    """Every fold at once on the fused train step; the trained parameters
    go back into ``model``. Returns (logs, steps this call ran, seconds of
    the run)."""
    trainer = FusedFoldTrainer(model, train_config, max_n)
    # one covariate block for every modality (uniform_covariates checked)
    batches = trainer.batches([f[0] for f in folds], [f[1][0] for f in folds],
                              device)
    eps = None
    if eps_fn is not None:
        eps = eps_fn(batches.valid_host.T, train_config.epochs,
                     train_config.batch_size, model.noise_dim)
    kernel = 'K6, bf16' if train_config.precision == 'bf16' else 'K5'
    print(f'train model (all folds fold-parallel, fused train-step CUDA '
          f'kernel {kernel})')
    packed = packed_from_model(model, trainer.stacked)
    start = time.perf_counter()
    trained, logs = resumable.run(trainer, packed, batches, eps=eps,
                                  state_dir=state_dir)
    run_s = time.perf_counter() - start
    packed_to_model(trained, trainer.stacked, model)
    epochs = train_config.epochs - resumable.resumed_from
    return logs, epochs * batches.n_batches, run_s


def _train(args, model, train_config, folds, max_n, eps_fn,
           resumable: common.Resumable, state_dir: Path):
    """Every fold at once on MultiFoldTrainer (plain or --fused_decoder
    loss); trains ``model`` in place. Returns (logs, steps this call ran,
    seconds of the run)."""
    batch_size = train_config.batch_size
    loss_fn = None
    if getattr(args, 'fused_decoder', False):
        loss_fn = fused_decoder_loss_fn(model, train_config)
        print('train model (fused decoder+NLL CUDA kernel pair)')
    trainer = MultiFoldTrainer(model, train_config, max_n, loss_fn=loss_fn)
    batches = stack_fold_batches([f[0] for f in folds], [f[1] for f in folds],
                                 batch_size)
    eps = None
    if eps_fn is not None:
        eps = eps_fn(batches['valid'], train_config.epochs, batch_size,
                     model.noise_dim)
    print('train model (all folds fold-parallel)')
    start = time.perf_counter()
    logs = resumable.run(trainer, batches, eps=eps, state_dir=state_dir)
    run_s = time.perf_counter() - start
    epochs = train_config.epochs - resumable.resumed_from
    return logs, epochs * batches['mask'].shape[1], run_s


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    common.add_common_flags(parser)
    parser.add_argument('--device', dest='device', default='cuda',
                        help='torch device to train on (default cuda); cuda '
                             'runs the kernels, cpu their plain versions')
    parser.add_argument('--lr_schedule', dest='lr_schedule',
                        default='constant', choices=['constant', 'cyclic'],
                        help='constant reproduces the reference (its cyclic '
                             'assignment is a no-op); cyclic enables the '
                             'intended triangular schedule.')
    parser.add_argument('--fold_parallel', dest='fold_parallel',
                        action='store_true',
                        help='accepted for the JAX CLI flag surface: the '
                             'port always trains every fold at once')
    parser.add_argument('--batch_size', dest='batch_size', type=int,
                        default=256,
                        help='training batch size (the reference hardcodes '
                             '256, train:197); other values are a different '
                             'trajectory.')
    parser.add_argument('--fused_decoder', dest='fused_decoder',
                        action='store_true',
                        help='run each modality\'s decoder mean head + '
                             'Gaussian NLL (forward and backward) through '
                             'the decoder_nll CUDA kernel pair, which keeps '
                             'the [B, D] means and residuals out of device '
                             'memory; cVAE_multimodal, fp32. Exits (never '
                             'falls back) for another -Model.')
    parser.add_argument('--no_fused_heads', dest='no_fused_heads',
                        action='store_true',
                        help='accepted for the JAX CLI flag surface: the '
                             'port always runs the mu and logvar heads as '
                             'two products (the same math as the merged '
                             'head)')
    parser.add_argument('--fused_train_step', dest='fused_train_step',
                        action='store_true',
                        help='run each optimizer step (forward and '
                             'hand-derived backward of every fold) as one '
                             'fused train-step CUDA kernel call on the '
                             'packed layout: K5 in fp32, K6 under '
                             '--precision bf16; cVAE_multimodal, poe/gpoe/'
                             'moe/mopoe, 1-3 hidden layers. Exits (never '
                             'falls back) on a configuration or a -Model it '
                             'does not take.')
    parser.add_argument('--precision', dest='precision', default='fp32',
                        choices=['fp32', 'bf16'],
                        help='fp32; bf16 runs only through the fused train '
                             'step (K6, with --fused_train_step) and raises '
                             'without it')
    parser.add_argument('--in_memory_fusion', dest='in_memory_fusion',
                        action='store_true',
                        help='build the UCA early-fusion modality by '
                             'concatenating the scaled base blocks in memory '
                             '(numerically identical; skips reading the '
                             'early_fusion CSV).')
    common.add_resume_flags(parser)
    not_ported = 'not ported yet (raises); see ROADMAP.md'
    for flag, kwargs in (('--mesh', {'default': None}),
                         ('--ep_mesh', {'default': None}),
                         ('--packed_xla', {'action': 'store_true'}),
                         ('--stream_shards', {'type': int, 'default': 0}),
                         ('--remat', {'action': 'store_true'}),
                         ('--profile_dir', {'default': None}),
                         ('--warmup_only', {'action': 'store_true'})):
        parser.add_argument(flag, dest=flag[2:], help=not_ported, **kwargs)
    return parser


def run(argv=None, project_root=None):
    args = build_parser().parse_args(argv)
    common.apply_post_parse_defaults(args)
    main(args, project_root=project_root)


if __name__ == '__main__':
    run()
