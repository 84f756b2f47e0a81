"""One-process experiment pipeline: train -> test -> group analysis
(counterpart of cli/pipeline.py).

The reference drives an experiment as three separate launches
(commands_list9.sh:4-16: multimodal_kfold_train_cvae_supervised.py, then
multimodal_kfold_test_cvae_supervised.py, then
multimodal_kfold_cvae_group_analysis_1x1.py). Each launch imports torch,
starts CUDA and loads the kernel library again. Running the chain in ONE
process pays for that once; the stage outputs are byte-identical to the
three-launch chain (same mains, same args). Usage:

    python -m multi_modal_normative_modeling_tpu_torch.cli.pipeline \\
        -R ADNI -P UCA-gPoE -E 200 -K 5 [--fused_train_step] [--device cpu]
        [-Model mmJSD|mvtCAE|DMVAE|WeightedDMVAE|mmVAEPlus] [--emit_latent]
        [--checkpoint_every N [--resume]] [--in_memory_fusion]

Select stages with --stages (comma-separated subset of train,test,analyze).
"""
from __future__ import annotations

import argparse
import time

from . import common, group_analysis, test_supervised, train_supervised

STAGES = ('train', 'test', 'analyze')


def build_parser() -> argparse.ArgumentParser:
    parser = train_supervised.build_parser()
    parser.description = __doc__.split('\n')[0]
    parser.add_argument('--stages', dest='stages', default='train,test,analyze',
                        help='comma-separated subset of train,test,analyze '
                             '(in that order).')
    parser.add_argument('--emit_latent', dest='emit_latent',
                        action='store_true',
                        help='test stage: also write per-fold '
                             'latent_deviation.csv.')
    parser.add_argument('--fused_inference', dest='fused_inference',
                        action='store_true',
                        help='accepted for the JAX CLI flag surface: on CUDA '
                             'the kernels are always the path')
    parser.add_argument('--threshold_method', dest='threshold_method',
                        default='roc',
                        choices=['roc', 'f1', 'pr', 'cost', 'eer'],
                        help="optimal-threshold finder for the analysis "
                             "stage (reference hardcodes 'roc').")
    return parser


def main(args, project_root=None):
    stages = [s.strip() for s in args.stages.split(',') if s.strip()]
    unknown = sorted(set(stages) - set(STAGES))
    if unknown:
        raise ValueError(f'unknown stages {unknown}; choose from '
                         f'{list(STAGES)}')
    # what either device stage refuses is refused before any stage runs
    common.refuse_not_ported(args, 'pipeline',
                             {**test_supervised._NOT_PORTED_FLAGS,
                              **train_supervised._NOT_PORTED_FLAGS})
    common.require_checkpoint_for_resume(args)
    stats = None
    for stage in STAGES:
        if stage not in stages:
            continue
        start = time.perf_counter()
        if stage == 'train':
            train_supervised.main(args, project_root=project_root)
        elif stage == 'test':
            test_supervised.main(args, project_root=project_root)
        else:
            stats = group_analysis.main(args, project_root=project_root)
        # every stage ends with its files written, so with the device idle
        print(f'pipeline: stage {stage} took '
              f'{time.perf_counter() - start:.3f} s', flush=True)
    return stats


def run(argv=None, project_root=None):
    args = build_parser().parse_args(argv)
    common.apply_post_parse_defaults(args)
    return main(args, project_root=project_root)


if __name__ == '__main__':
    run()
