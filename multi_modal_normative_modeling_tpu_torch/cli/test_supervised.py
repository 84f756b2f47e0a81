"""Per-fold deviation scoring (counterpart of cli/test_supervised.py).

For each fold: re-fit the scaler on the fold's train rows, re-bin the test
covariates (reference quirk, SURVEY.md Q5), restore the fold checkpoint the
JAX trainer wrote, run the stochastic reconstruction (SURVEY.md Q2) and
write the five deviation CSVs per (fold, modality) plus the all-fold copies,
through the JAX package's DeviationEmitter.

All folds are scored by one call of ``MultimodalCVAE.pred_recon_fused`` on
a fold-stacked model: on CUDA each modality is one encoder kernel launch and
one decode+deviation kernel launch covering every fold. As in the JAX CLI,
the CSV deviation is recomputed in float64 on the host from the float64
scaled data and the float32 predictions, so the CSVs match the JAX ones.

    python -m multi_modal_normative_modeling_tpu_torch.cli.test_supervised \
        -R ADNI -P UCA-gPoE -K 5
"""
from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from multi_modal_normative_modeling_tpu import registry
from multi_modal_normative_modeling_tpu.infer.emitters import DeviationEmitter

from ..interop import params_from_jax, read_flax_checkpoint
from ..parallel import stack_params
from . import common
from .common import resolve_device

# JAX CLI flags with no port yet: each raises instead of being ignored
_NOT_PORTED_FLAGS = {
    'mesh': "queue 1 item 'Multi-device'",
    'ep_mesh': "queue 1 item 'Multi-device'",
    'in_memory_fusion': "queue 1 item 'Main-path CLI chain'",
    'emit_latent': "queue 1 item 'Main-path CLI chain'",
}

EpsFn = Callable[[int, int, int], np.ndarray]


def default_eps(fold: int, padded_rows: int, z_dim: int) -> np.ndarray:
    """The fold's reparameterization noise: a torch.Generator seeded with
    1000 + fold (the JAX package draws from PRNGKey(1000 + fold); the two
    streams differ, tests replay the JAX draws through ``eps_fn``)."""
    gen = torch.Generator().manual_seed(1000 + fold)
    return torch.randn((padded_rows, z_dim), generator=gen).numpy()


def main(args, project_root=None, eps_fn: Optional[EpsFn] = None):
    for flag, item in _NOT_PORTED_FLAGS.items():
        if getattr(args, flag, None):
            raise SystemExit(f'--{flag} is not ported to the torch test stage '
                             f'yet; see ROADMAP.md, {item}')
    device = resolve_device(getattr(args, 'device', 'cuda'), 'score')
    eps_fn = eps_fn or default_eps

    project_root = Path(project_root) if project_root else Path.cwd()
    model_name = 'supervised_cvae'
    participants_path = project_root / 'data' / args.dataset_resourse / 'y.csv'
    kfold_dir = project_root / 'outputs' / 'kfold_analysis'
    model_dir = kfold_dir / model_name
    deviation_dir = (project_root / 'deviation' / model_name /
                     args.dataset_resourse / args.procedure / 'path_model')
    deviation_dir.mkdir(exist_ok=True, parents=True)

    dataset_names = registry.get_datasets_name(args.dataset_resourse,
                                               args.procedure)
    if args.combine is None:
        raise ValueError(f'Unknown procedure: {args.procedure}')
    emitter = DeviationEmitter(dataset_names)

    jobs = []
    for fold in range(args.n_splits):
        train_ids_path, test_ids_path = common.fold_paths(kfold_dir, fold)
        (model_dir / f'{fold:03d}').mkdir(exist_ok=True, parents=True)
        for dataset_name in dataset_names:
            jobs.append((dataset_name, train_ids_path, test_ids_path))
    with ThreadPoolExecutor(max_workers=8) as pool:
        read = common.shared_tables(pool, project_root, args.dataset_resourse,
                                    dataset_names, participants_path)
        all_preps = list(pool.map(
            lambda j: common.prepare_modality(
                project_root, args.dataset_resourse, j[0],
                participants_path, j[1], j[2], read), jobs))

    # ---- phase 1: per-fold splits + restored params (host side) ----------
    n_mod = len(dataset_names)
    pending = []
    config = None
    for fold in range(args.n_splits):
        fold_model_dir = model_dir / f'{fold:03d}'
        preps = all_preps[fold * n_mod:(fold + 1) * n_mod]
        common.assert_modalities_aligned(
            [p['test_df'] for p in preps], f'test stage fold {fold}')
        if not (fold_model_dir / 'cVAE_model.ckpt').exists():
            print('firstly train model')
            continue
        print('load trained model')
        params, config = read_flax_checkpoint(fold_model_dir)
        pending.append({
            'fold': fold,
            'dir': fold_model_dir,
            'params': params,
            'test_data_list': [p['test_data'] for p in preps],
            'clinical_df': preps[0]['test_df'],
            'columns_list': [p['columns'] for p in preps],
            # last modality wins (test:102)
            'test_cov': common.require_test_cov(preps[-1],
                                                f'test fold {fold}'),
        })

    # ---- phase 2: one scoring call over the stacked fold axis ------------
    if pending:
        # every fold padded to one row bucket; rows are independent through
        # the model, so pad rows change nothing
        max_rows = max(j['test_data_list'][0].shape[0] for j in pending)
        tile = common.infer_row_tile()
        padded_rows = -(-max_rows // tile) * tile

        def stacked(arrays):
            out = np.zeros((len(arrays), padded_rows, arrays[0].shape[1]),
                           np.float32)
            for i, a in enumerate(arrays):
                out[i, :a.shape[0]] = a
            return torch.from_numpy(out).to(device)

        model = common.build_model_from_config(config, folds=len(pending))
        params_from_jax(stack_params([j['params'] for j in pending]), model,
                        device)
        xes = [stacked([j['test_data_list'][m] for j in pending])
               for m in range(n_mod)]
        c = stacked([j['test_cov'] for j in pending])
        eps = torch.from_numpy(np.stack([
            np.asarray(eps_fn(j['fold'], padded_rows, model.latent_dim),
                       np.float32)
            for j in pending])).to(device)
        recons, _ = model.pred_recon_fused(xes, [c] * n_mod, args.combine,
                                           eps=eps)
        host_preds = [r.cpu().numpy() for r in recons]

        # ---- phase 3: per-fold float64 deviation + CSV emission ----------
        for i, job in enumerate(pending):
            n_rows = job['test_data_list'][0].shape[0]
            preds = [host_preds[m][i, :n_rows] for m in range(n_mod)]
            # float64 deviation from the float64 scaled data and float32
            # predictions (test:113, cVAE.py:1210)
            deviations = [
                np.sum((job['test_data_list'][m] - preds[m]) ** 2, axis=1)
                / job['test_data_list'][m].shape[1]
                for m in range(n_mod)
            ]
            for m, dataset_name in enumerate(dataset_names):
                emitter.emit_fold(
                    job['dir'], dataset_name, job['columns_list'][m],
                    job['clinical_df'][['participant_id', 'DIA', 'AGE',
                                        'PTGENDER']],
                    job['test_data_list'][m], preds[m], deviations[m],
                )
    emitter.emit_combined(deviation_dir)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument('-R', '--dataset_resourse', dest='dataset_resourse',
                        type=str,
                        help='Dataset to use for training test and evaluation.')
    parser.add_argument('-H', '--hz_para_list', dest='hz_para_list', nargs='+',
                        type=int, help='List of paras to perform the analysis.')
    parser.add_argument('-C', '--combine', dest='combine', type=str,
                        help='how do we combine all modalities.')
    parser.add_argument('-P', '--procedure', dest='procedure', type=str,
                        help='Procedure to perform the analysis.')
    parser.add_argument('-K', '--n_splits', dest='n_splits', type=int,
                        default=10,
                        help='Number of splits for k-fold cross-validation.')
    parser.add_argument('--device', dest='device', default='cuda',
                        help='torch device to score on (default cuda); cuda '
                             'runs the kernels, cpu their plain versions')
    parser.add_argument('--fused_inference', dest='fused_inference',
                        action='store_true',
                        help='accepted for the JAX CLI flag surface: on CUDA '
                             'the kernels are always the path')
    not_ported = 'not ported yet (raises); see ROADMAP.md'
    parser.add_argument('--mesh', dest='mesh', default=None, metavar='F,D',
                        help=not_ported)
    parser.add_argument('--ep_mesh', dest='ep_mesh', default=None,
                        metavar='M,D', help=not_ported)
    parser.add_argument('--in_memory_fusion', dest='in_memory_fusion',
                        action='store_true', help=not_ported)
    parser.add_argument('--emit_latent', dest='emit_latent',
                        action='store_true', help=not_ported)
    return parser


def run(argv=None, project_root=None):
    args = common.apply_post_parse_defaults(build_parser().parse_args(argv))
    main(args, project_root=project_root)


if __name__ == '__main__':
    run()
