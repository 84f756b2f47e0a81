"""Per-fold deviation scoring (counterpart of cli/test_supervised.py).

For each fold: re-fit the scaler on the fold's train rows, re-bin the test
covariates (reference quirk, SURVEY.md Q5), restore the fold checkpoint the
JAX trainer wrote, run the stochastic reconstruction (SURVEY.md Q2) and
write the five deviation CSVs per (fold, modality) plus the all-fold copies,
through the DeviationEmitter (infer/emitters.py).

All folds are scored by one call on a fold-stacked model. A model of the
cVAE skeleton (cVAE_multimodal, mmJSD, mvtCAE) goes through
``MultimodalCVAE.pred_recon_fused``: on CUDA each modality is one encoder
kernel launch and one decode+deviation kernel launch covering every fold,
with the variant's fusion in torch between them, and a launch that fails
raises (there is no way from there to the plain version). The DMVAE family
has no kernel in the JAX package and none here: it goes through
``pred_recon``. As in the JAX CLI, the CSV deviation is recomputed in
float64 on the host from the float64 scaled data and the float32
predictions, so the CSVs match the JAX ones. ``--emit_latent`` also writes
``latent_deviation.csv`` per fold for the models that have ``latent_stats``.
``--in_memory_fusion`` builds a UCA procedure's early-fusion modality from
the scaled base modalities instead of reading its CSV.

``--mesh F,D`` (or the train stage's F,D,M, whose 'model' axis folds into
'data') scores on a mesh of ranks, one process each (``python -m
torch.distributed.run``): a rank holds folds [i F/nf, (i+1) F/nf) and rows
[j R/nd, (j+1) R/nd) of the padded rows (R a multiple of lcm(64, D)), draws
each of its folds' whole noise and keeps its rows, and calls the same
``pred_recon_fused`` on its contiguous [F/nf, R/nd, D] slice: K1 and K2 on
CUDA. Rank 0 gathers the predictions and writes every CSV.

``--ep_mesh F,M,D`` (or M,D, a fold axis of 1) scores expert-parallel: a
rank holds its folds and rows as on ``--mesh`` and scores the modalities it
owns (its block of the width-grouped order, parallel/modality.py
``owned_modalities``; one modality a rank on ADHD's 2 x 116 at M = 2): K1
on each of them at the modality's own width, the fusion as sums over its
modalities and one all_reduce over 'modality' (``fused_stats_collective``),
z from the fold's noise, then K2 on each of them. Rank 0 gathers and writes
the CSVs.

    python -m multi_modal_normative_modeling_tpu_torch.cli.test_supervised \
        -R ADNI -P UCA-gPoE -K 5 [--emit_latent] [--in_memory_fusion]
        [--mesh F,D | --ep_mesh [F,]M,D]
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ..infer.deviation import latent_deviation, separate_latent_deviation

from .. import registry
from ..infer.emitters import DeviationEmitter
from ..parallel.mesh import fold_range
from ..train.checkpoints import checkpoint_exists
from ..models.stacked import SKELETON_VARIANTS
from . import common
from .common import resolve_device

EP_USAGE = '4,2 (modality,data) or 2,2,2 (fold,modality,data)'

EpsFn = Callable[[int, int, int], np.ndarray]


def default_eps(fold: int, padded_rows: int, z_dim: int) -> np.ndarray:
    """The fold's reparameterization noise: a torch.Generator seeded with
    1000 + fold (the JAX package draws from PRNGKey(1000 + fold); the two
    streams differ, tests replay the JAX draws through ``eps_fn``).
    ``z_dim`` is the model's ``noise_dim`` (0 for a DMVAE-family model whose
    shared code is empty)."""
    return common.seeded_eps(1000 + fold, padded_rows, z_dim)


def main(args, project_root=None, eps_fn: Optional[EpsFn] = None,
         timings: Optional[dict] = None):
    """``eps_fn(fold, padded rows, latent)`` gives the scoring noise
    (default ``default_eps``); ``timings``, when given, receives the walls
    of the stage's phases: 'csv parse', 'prep' (merge, scaling, covariate
    bins), 'restore', 'scoring call' (the device's part, with the copies
    to and from it) and 'csv emit' (the host deviation and the CSVs)."""
    device = resolve_device(getattr(args, 'device', 'cuda'), 'score')
    mesh = common.parse_infer_mesh(getattr(args, 'mesh', None), device)
    if mesh is not None:
        device = mesh.device
        common.announce_mesh(mesh, 'test inference')
    ep = _ep_mesh(args, mesh, device)
    if ep is not None:
        mesh = ep
        device = mesh.device
    primary = mesh is None or mesh.primary
    eps_fn = eps_fn or default_eps
    walls = common.StageWalls(
        None if timings is None else timings.setdefault('walls', {}),
        accumulate=True)

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

    for fold in range(args.n_splits):
        (model_dir / f'{fold:03d}').mkdir(exist_ok=True, parents=True)
    # with --in_memory_fusion the early-fusion modality's splits are
    # fuse_preps of the base modalities'; its CSVs keep its dataset name
    fold_preps = common.prepare_fold_modalities(
        project_root, args.dataset_resourse, dataset_names, participants_path,
        [common.fold_paths(kfold_dir, fold) for fold in range(args.n_splits)],
        fuse=common.in_memory_fusion(args), walls=walls)

    # ---- phase 1: per-fold splits + restored params (host side) ----------
    n_mod = len(dataset_names)
    pending = []
    for fold, preps in enumerate(fold_preps):
        fold_model_dir = model_dir / f'{fold:03d}'
        common.assert_modalities_aligned(
            [p['test_df'] for p in preps], f'test stage fold {fold}')
        if not checkpoint_exists(fold_model_dir):
            print('firstly train model')
            continue
        print('load trained model')
        pending.append({
            'fold': fold,
            'dir': fold_model_dir,
            'test_data_list': [p['test_data'] for p in preps],
            'clinical_df': preps[0]['test_df'],
            'columns_list': [p['columns'] for p in preps],
            # last modality wins (test:102)
            'test_cov': common.require_test_cov(preps[-1],
                                                f'test fold {fold}'),
            'train_data_list': [p['train_data'] for p in preps],
            'train_cov': preps[-1]['train_cov'],
        })

    # ---- phase 2: one scoring call over the stacked fold axis ------------
    if pending:
        if ep is not None and len(pending) % ep.axis('fold'):
            raise SystemExit(
                f"--ep_mesh: {len(pending)} folds with checkpoints not "
                f"divisible by the fold axis ({ep.axis('fold')})")
        common.check_infer_fold_axis(mesh, len(pending),
                                     'folds with checkpoints')
        mine = pending
        if mesh is not None:
            f0, f1 = fold_range(mesh, len(pending))
            mine = pending[f0:f1]
        with walls('restore'):
            model, _, config = common.load_model_and_params(
                [j['dir'] for j in mine], device)
        with walls('scoring call'):
            if ep is not None:
                host_preds, latent = _score_ep(args, model, config, pending,
                                               eps_fn, device, ep)
            else:
                host_preds, latent = _score(args, model, pending, eps_fn,
                                            device, mesh)
        if not primary:
            pending = []

        # ---- phase 3: per-fold float64 deviation + CSV emission ----------
        with walls('csv emit'):
            for i, job in enumerate(pending):
                n_rows = job['test_data_list'][0].shape[0]
                preds = [host_preds[m][i, :n_rows] for m in range(n_mod)]
                # float64 deviation from the float64 scaled data and float32
                # predictions (test:113, cVAE.py:1210)
                deviations = [
                    np.sum((job['test_data_list'][m] - preds[m]) ** 2,
                           axis=1) / job['test_data_list'][m].shape[1]
                    for m in range(n_mod)
                ]
                for m, dataset_name in enumerate(dataset_names):
                    emitter.emit_fold(
                        job['dir'], dataset_name, job['columns_list'][m],
                        job['clinical_df'][['participant_id', 'DIA', 'AGE',
                                            'PTGENDER']],
                        job['test_data_list'][m], preds[m], deviations[m],
                    )
                if latent is not None:
                    (mu_train, _), (mu_test, var_test) = latent
                    _emit_latent(
                        job['dir'], job['clinical_df'],
                        mu_train[i, :job['train_data_list'][0].shape[0]],
                        mu_test[i, :n_rows], var_test[i, :n_rows])
    if primary:
        with walls('csv emit'):
            emitter.emit_combined(deviation_dir)
    if mesh is not None:
        mesh.barrier()


def _ep_mesh(args, mesh, device):
    """--ep_mesh's ('fold', 'modality', 'data') mesh after the JAX CLI's
    gates, in its words (cli/test_supervised.py:226-246); None without
    the flag. M,D runs as 1,M,D."""
    spec = getattr(args, 'ep_mesh', None)
    if not spec:
        return None
    if mesh is not None:
        raise SystemExit('--ep_mesh is mutually exclusive with --mesh')
    sizes = common.parse_axis_sizes(spec, '--ep_mesh', (2, 3), EP_USAGE)
    if len(sizes) == 2:
        sizes = [1] + sizes
    modalities = len(registry.get_datasets_name(args.dataset_resourse,
                                                args.procedure))
    indivisible = common.ep_mesh_divisibility(sizes, args.n_splits, 1,
                                              modalities)
    if indivisible:
        raise SystemExit(f'--ep_mesh {spec}: {indivisible}')
    from ..parallel.modality import make_ep_mesh3

    ep = make_ep_mesh3(*sizes, device=device)
    if ep.primary:
        print(f'test inference expert-parallel over a {dict(ep.shape)} '
              f'device mesh ({ep.size} ranks, {ep.backend or "no"} process '
              f'group, {ep.device})', flush=True)
    return ep


def _score_ep(args, model, config, pending, eps_fn: EpsFn, device, mesh):
    """``_score`` on an expert-parallel mesh: this rank's folds and rows of
    the modalities it owns, through K1, the collective fusion and K2
    (parallel.modality.ep_pred_recon_fused); the ranks' parts gathered on
    every rank."""
    from ..parallel.modality import (
        ep_pred_recon_fused,
        gather_owned,
        owned_modalities,
    )

    name = config.get('model', 'cVAE_multimodal')
    if name not in SKELETON_VARIANTS:
        raise SystemExit(
            f"--ep_mesh inference supports the cVAE skeleton only "
            f"({sorted(SKELETON_VARIANTS)}; checkpoint model {name!r})")
    if getattr(args, 'emit_latent', False):
        raise SystemExit('--emit_latent is not available under --ep_mesh '
                         '(the JAX expert-parallel stage writes no latent '
                         'deviations either)')
    n_mod = len(pending[0]['test_data_list'])
    owned = owned_modalities(mesh, model.input_dim_list)
    padded_rows = common.padded_rows(
        max(j['test_data_list'][0].shape[0] for j in pending), mesh)
    folds, rows = common.mesh_parts(mesh, len(pending), padded_rows)
    mine = pending[folds]

    def stacked(arrays):
        return common.stack_padded(arrays, padded_rows, device, rows)

    xes = {m: stacked([j['test_data_list'][m] for j in mine])
           for m in owned}
    c = stacked([j['test_cov'] for j in mine])
    eps = torch.from_numpy(np.ascontiguousarray(np.stack([
        np.asarray(eps_fn(j['fold'], padded_rows, model.noise_dim),
                   np.float32).reshape(padded_rows, model.noise_dim)[rows]
        for j in mine]))).to(device)
    out = ep_pred_recon_fused(model, owned, xes, dict.fromkeys(owned, c),
                              args.combine, eps, mesh)
    return gather_owned(mesh, {m: out[m][0].cpu().numpy() for m in owned},
                        len(pending), n_mod), None


def _score(args, model, pending, eps_fn: EpsFn, device, mesh=None):
    """One call over the stacked fold axis: (the recon means per modality,
    [F, rows, D_m] numpy, and with --emit_latent the train and test
    splits' latent statistics). Every fold is padded to one row bucket;
    rows are independent through the model, so pad rows change nothing.
    On a mesh ``model`` holds this rank's folds: it scores its rows of
    them, and the ranks' parts are gathered on every rank."""
    n_mod = len(pending[0]['test_data_list'])
    padded_rows = common.padded_rows(
        max(j['test_data_list'][0].shape[0] for j in pending), mesh)
    folds, rows = common.mesh_parts(mesh, len(pending), padded_rows)
    mine = pending[folds]

    def stacked(arrays, rows_to=padded_rows, part=rows):
        return common.stack_padded(arrays, rows_to, device, part)

    xes = [stacked([j['test_data_list'][m] for j in mine])
           for m in range(n_mod)]
    c = stacked([j['test_cov'] for j in mine])
    eps = torch.from_numpy(np.ascontiguousarray(np.stack([
        np.asarray(eps_fn(j['fold'], padded_rows, model.noise_dim),
                   np.float32).reshape(padded_rows, model.noise_dim)[rows]
        for j in mine]))).to(device)
    if hasattr(model, 'pred_recon_fused'):
        recons, _ = model.pred_recon_fused(xes, [c] * n_mod, args.combine,
                                           eps=eps)
    else:
        with torch.no_grad():
            recons = model.pred_recon(xes, [c] * n_mod, args.combine,
                                      eps=eps)
    host_preds = common.gather_parts(mesh, [r.cpu().numpy() for r in recons],
                                     len(pending))
    latent = None
    if (getattr(args, 'emit_latent', False)
            and hasattr(model, 'latent_stats')):
        # rows are independent through the encoders and the fusion, so
        # each fold's padding rows change nothing above them; on a mesh a
        # rank takes its rows of both splits
        train_rows = max(j['train_data_list'][0].shape[0] for j in pending)
        train_part = rows
        if mesh is not None:
            train_rows = common.padded_rows(train_rows, mesh)
            train_part = common.mesh_parts(mesh, len(pending), train_rows)[1]
        train_xes = [stacked([j['train_data_list'][m] for j in mine],
                             train_rows, train_part) for m in range(n_mod)]
        train_c = stacked([j['train_cov'] for j in mine], train_rows,
                          train_part)
        with torch.no_grad():
            latent = [
                tuple(t.cpu().numpy() for t in model.latent_stats(
                    inputs, [cov] * n_mod, args.combine))
                for inputs, cov in ((train_xes, train_c), (xes, c))]
        latent = [tuple(common.gather_parts(mesh, pair, len(pending)))
                  for pair in latent]
    return host_preds, latent


def _emit_latent(fold_model_dir, clinical_df, mu_train, mu_test, var_test):
    """The fold's ``latent_deviation.csv`` (cli/test_supervised.py:445-470
    of the JAX package): the scalar and the per-dimension latent z-scores of
    the test rows against the fold's train cohort, from the fused latent
    statistics the device computed."""
    frame = clinical_df[['participant_id', 'DIA', 'AGE', 'PTGENDER']].copy()
    frame['Latent deviation'] = latent_deviation(mu_train, mu_test, var_test)
    per_dim = separate_latent_deviation(mu_train, mu_test, var_test)
    for i in range(per_dim.shape[1]):
        frame[f'latent {i}'] = per_dim[:, i]
    frame.to_csv(Path(fold_model_dir) / 'latent_deviation.csv', index=False)


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
    parser.add_argument('--mesh', dest='mesh', default=None, metavar='F,D',
                        help='score on a (fold, data) mesh of ranks, one '
                             'process each: folds over F, padded test rows '
                             'over D (the train stage\'s F,D,M runs as '
                             'F,D*M); rank 0 writes the CSVs')
    parser.add_argument('--ep_mesh', dest='ep_mesh', default=None,
                        metavar='[F,]M,D',
                        help='score expert-parallel on a (fold, modality, '
                             'data) mesh of ranks (M,D: a fold axis of 1): '
                             'each rank runs K1 and K2 on the modalities it '
                             'owns, the fusion as collectives; rank 0 '
                             'writes the CSVs')
    parser.add_argument('--in_memory_fusion', dest='in_memory_fusion',
                        action='store_true',
                        help='build the UCA early-fusion modality by '
                             'concatenating the scaled base blocks in memory '
                             '(numerically identical; skips reading the '
                             'early_fusion CSV).')
    parser.add_argument('--emit_latent', dest='emit_latent',
                        action='store_true',
                        help='also write per-fold latent_deviation.csv '
                             '(scalar + per-dim latent z-scores against the '
                             'train cohort); models with latent_stats only.')
    return parser


def run(argv=None, project_root=None):
    args = common.apply_post_parse_defaults(build_parser().parse_args(argv))
    main(args, project_root=project_root)
    from ..parallel import distributed

    distributed.shutdown()


if __name__ == '__main__':
    run()
