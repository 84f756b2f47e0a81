"""The nm-PM-cont margins x contrastive-weights grid in one run
(counterpart of cli/sweep_endtoend.py).

The replacement of commands_list9_endtoend.sh's bash loop: every (margin,
weight) config x every fold trains at once (``parallel.SweepTrainer``: one
end-to-end model of S * F stacked folds), then every config's folds are
classified in one fold-stacked ``EndToEndCVAE.predict`` call (on CUDA the
encoder kernel once per modality for all S * F folds), and one block of
per-metric means and stds per config is appended to results_endtoend.csv,
as sequential nmpmcont runs append them. The fold ids and data prep are
nmpmcont's.

    python -m multi_modal_normative_modeling_tpu_torch.cli.sweep_endtoend \\
        -R ADNI -P SE-MoE -K 5 -H 110 110 10 -Layers 128 64 32 \\
        -Margins 0.25 0.5 1 2 -Weightcontrastives 0.1 0.5 1 -E 200 \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Optional

import numpy as np

from .. import registry
from ..evaluation.reports import append_endtoend_results
from ..models.endtoend import EndToEndCVAE, endtoend_loss_fn
from ..parallel.sweep import SweepTrainer
from ..train import TrainConfig
from . import common
from .nmpmcont import (
    default_init,
    fold_batches,
    fold_metrics,
    prepare_cohort,
    test_inputs,
)

_NOT_PORTED_FLAGS = {'mesh': "queue 1 item 'Multi-device'"}


def main(args, project_root=None, init_fn: Optional[common.InitFn] = None,
         draws_fn: Optional[common.DrawsFn] = None,
         timings: Optional[dict] = None):
    """``init_fn(model)`` fills the S * F-fold model's initial weights
    (default: nmpmcont's, one fold seeded 42 for every stacked fold);
    ``draws_fn(valid [S * F, NB], epochs, rows, model)`` gives the replayed
    draws of every stacked fold (tests replay the JAX package's); by
    default every stacked fold draws from its own generator seeded 42.
    ``timings``, when given, receives the stages' walls, the training steps
    and seconds, and the prediction call's rows. Returns {(margin, weight):
    per-fold metrics}."""
    common.refuse_not_ported(args, 'end-to-end sweep', _NOT_PORTED_FLAGS)
    device = common.resolve_device(getattr(args, 'device', 'cuda'), 'train')
    timings = {} if timings is None else timings
    walls = common.StageWalls(timings.setdefault('walls', {}))
    project_root = Path(project_root) if project_root else Path.cwd()
    modalities = len(registry.get_datasets_name(args.dataset_resourse,
                                                args.procedure))
    fold_data, input_dim_list, c_dim = prepare_cohort(args, project_root,
                                                      walls)
    n_folds = len(fold_data)

    configs = [{'margin': m, 'wcon': w}
               for m in args.margins for w in args.weightcontrastives]
    n_configs = len(configs)
    model = EndToEndCVAE(input_dim_list, args.hz_para_list[:-1],
                         args.hz_para_list[-1], c_dim, modalities,
                         non_linear=True, classifier_layers=args.layers,
                         dropout_rate=0.5, num_classes=2,
                         folds=n_configs * n_folds)
    (init_fn or default_init)(model)
    model.to(device)
    config = TrainConfig(epochs=args.epochs, batch_size=256,
                         learning_rate=0.0001, combine='poe', seed=42)
    print(f'training grid: {n_configs} configs x {n_folds} folds in one '
          f'fold-stacked run of {n_configs * n_folds} folds')
    with walls('train'):
        batches = fold_batches(fold_data, config.batch_size)
        draws = {}
        if draws_fn is not None:
            draws = draws_fn(np.concatenate([batches['valid']] * n_configs),
                             config.epochs, config.batch_size, model)
        sweep = SweepTrainer(
            model, config, fold_data[0]['train_data'][0].shape[0],
            lambda hyper: endtoend_loss_fn(model, hyper['margin'],
                                           hyper['wcon']),
            state_update=model.update_state)
        start = time.perf_counter()
        sweep.run(batches, configs, **draws)
        timings['train_run_s'] = time.perf_counter() - start
        timings['train_steps'] = config.epochs * batches['mask'].shape[1]

    with walls('score'):
        xes, cs, rows = test_inputs(fold_data, modalities, device,
                                    repeats=n_configs)
        all_logits = model.predict(xes, cs).cpu().numpy()
        timings['score_rows'] = rows

    results = {}
    with walls('write'):
        for s, hyper in enumerate(configs):
            frame = fold_metrics(
                fold_data, all_logits[s * n_folds:(s + 1) * n_folds])
            cfg_args = argparse.Namespace(**vars(args), margin=hyper['margin'],
                                          weightcontrastive=hyper['wcon'])
            append_endtoend_results(project_root / 'results_endtoend.csv',
                                    cfg_args, frame)
            results[(hyper['margin'], hyper['wcon'])] = frame
            print(f"margin={hyper['margin']} wcon={hyper['wcon']}: "
                  f"acc {frame['accuracy'].mean():.3f} "
                  f"auroc {frame['auroc'].mean():.3f}")
    walls.report('sweep_endtoend')
    return results


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='Whole-grid nm-PM-cont hyperparameter sweep.')
    common.add_common_flags(parser, default_n_splits=5)
    parser.add_argument('-Margins', '--margins', nargs='+', type=float,
                        default=[0.5, 1.0])
    parser.add_argument('-Weightcontrastives', '--weightcontrastives',
                        nargs='+', type=float, default=[0.1, 1.0])
    parser.add_argument('-Layers', '--layers', nargs='+', type=int,
                        default=[128, 64, 32])
    parser.add_argument('--device', dest='device', default='cuda',
                        help='torch device to run on (default cuda); cuda '
                             'runs the kernels, cpu their plain versions')
    parser.add_argument('--mesh', dest='mesh', default=None,
                        help='not ported yet (raises); see ROADMAP.md')
    return parser


def run(argv=None, project_root=None):
    args = build_parser().parse_args(argv)
    common.apply_post_parse_defaults(args, default_procedure='SE-MoE')
    return main(args, project_root=project_root)


if __name__ == '__main__':
    run()
