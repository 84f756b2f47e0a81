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

    python -m multi_modal_normative_modeling_tpu_torch.cli.train_supervised \\
        -R ADNI -P UCA-gPoE -E 200 -K 5 [--fused_decoder] [--device cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import pandas as pd
import torch

from multi_modal_normative_modeling_tpu import registry
from multi_modal_normative_modeling_tpu.utils.logging import RunLog

from ..interop import params_to_jax
from ..kernels.decoder_nll import fused_decoder_loss_fn
from ..models import build_model
from ..parallel import MultiFoldTrainer, stack_fold_batches
from ..train import TrainConfig
from . import common

# JAX CLI flags with no port yet: each raises instead of being ignored
_NOT_PORTED_FLAGS = {
    'mesh': "queue 1 item 'Multi-device'",
    'ep_mesh': "queue 1 item 'Multi-device'",
    'packed_xla': "queue 1 items 'Packed layout' and 'Grouped layout'",
    'fused_train_step': "queue 2, K5 and K6",
    'stream_shards': "queue 1 item 'Streaming'",
    'checkpoint_every': "queue 1 item 'Resume'",
    'resume': "queue 1 item 'Resume'",
    'remat': "queue 1 item 'Trainer'",
    'in_memory_fusion': "queue 1 item 'Main-path CLI chain'",
    'profile_dir': "queue 1 item 'Tooling'",
    'warmup_only': "'Do not port' (a TPU compile-cache warm-up)",
}

InitFn = Callable[[torch.nn.Module], None]
EpsFn = Callable[[np.ndarray, int, int, int], np.ndarray]


def default_init(model) -> None:
    """Every fold starts from the same weights, as the reference re-seeds 42
    per fold (train:119): one fold drawn from torch.Generator seeded 42,
    repeated over the model's folds."""
    one = build_model('cVAE_multimodal', model.input_dim_list,
                      model.hidden_dim, model.latent_dim, model.c_dim,
                      model.modalities, model.non_linear, folds=1,
                      generator=torch.Generator().manual_seed(42))
    model.load_state_dict({
        k: v.expand((model.folds,) + v.shape[1:]).clone()
        for k, v in one.state_dict().items()})


def main(args, project_root=None, init_fn: Optional[InitFn] = None,
         eps_fn: Optional[EpsFn] = None):
    """``init_fn(model)`` fills the fold-stacked model's initial weights
    (default: ``default_init``). ``eps_fn(valid [F, NB], epochs, batch rows,
    latent dim)`` gives the noise of every step, [epochs * NB, F, rows, Z]
    (tests replay the JAX package's draws); by default every fold draws from
    its own generator on the device."""
    for flag, item in _NOT_PORTED_FLAGS.items():
        if getattr(args, flag, None):
            raise SystemExit(f'--{flag} is not ported to the torch trainer '
                             f'yet; see ROADMAP.md, {item}')
    if getattr(args, 'precision', 'fp32') != 'fp32':
        raise SystemExit(f'--precision {args.precision} is not ported to the '
                         "torch trainer yet; see ROADMAP.md, queue 1 item "
                         "'Trainer'")
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
    )

    model = common.build_model_from_config(config_dict, folds=n_folds)
    (init_fn or default_init)(model)
    model.to(device)
    loss_fn = None
    if getattr(args, 'fused_decoder', False):
        loss_fn = fused_decoder_loss_fn(model, train_config)
        print('train model (fused decoder+NLL CUDA kernel pair)')
    max_n = max(f[0][0].shape[0] for f in folds)
    trainer = MultiFoldTrainer(model, train_config, max_n, loss_fn=loss_fn)
    batches = stack_fold_batches([f[0] for f in folds], [f[1] for f in folds],
                                 batch_size)
    eps = None
    if eps_fn is not None:
        eps = eps_fn(batches['valid'], train_config.epochs, batch_size,
                     model.latent_dim)
    print('train model (all folds fold-parallel)')
    logs = trainer.run(batches, eps=eps)

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
    run_log.event('train_end', folds=n_folds)


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
                             'memory; cvae variant, fp32.')
    parser.add_argument('--no_fused_heads', dest='no_fused_heads',
                        action='store_true',
                        help='accepted for the JAX CLI flag surface: the '
                             'port always runs the mu and logvar heads as '
                             'two products (the same math as the merged '
                             'head)')
    parser.add_argument('--precision', dest='precision', default='fp32',
                        choices=['fp32', 'bf16'],
                        help='fp32; bf16 is not ported yet (raises)')
    not_ported = 'not ported yet (raises); see ROADMAP.md'
    for flag, kwargs in (('--mesh', {'default': None}),
                         ('--ep_mesh', {'default': None}),
                         ('--packed_xla', {'action': 'store_true'}),
                         ('--fused_train_step', {'action': 'store_true'}),
                         ('--stream_shards', {'type': int, 'default': 0}),
                         ('--checkpoint_every', {'type': int, 'default': 0}),
                         ('--resume', {'action': 'store_true'}),
                         ('--remat', {'action': 'store_true'}),
                         ('--in_memory_fusion', {'action': 'store_true'}),
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
