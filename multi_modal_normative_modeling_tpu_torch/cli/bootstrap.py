"""Bootstrap-resampled normative modeling (counterpart of cli/bootstrap.py;
the reference commands_list10.sh's bootstrap_*.py chain).

The same actions, flags and files as the JAX CLI:

* ``create_ids``: train = n draws with replacement from the training-class
  group (``np.random.seed(42)`` then ``np.random.choice``); test = the
  out-of-bag training-class subjects + every other-group subject. Files
  land in ``outputs/bootstrap_analysis/{train,test}_ids_%03d.csv``; stale
  files of an earlier, larger -B run are removed first.
* ``-D 3modalities`` resolves to ``early_fusion_modalities_<R>``, built in
  memory from the base modalities (``common.fuse_preps``) when its CSV is
  absent.
* ``train``: the B replicates are the folds of one fold-stacked model on
  ``MultiFoldTrainer`` (batch 256, Adam 1e-4, no shuffle, gPoE, which for
  one modality is the M = 1 shortcut); replicate b draws its noise from a
  torch generator seeded 1000 + b. ``--checkpoint_every`` / ``--resume``
  keep one whole-run train state in the model dir. Checkpoints and config
  JSON per replicate, in dirs named by replicate id.
* ``test``: every replicate's out-of-bag split, rows padded to the scoring
  call's 64-row bucket, scored by ONE fold-stacked ``pred_recon_fused``
  call: on CUDA one encoder kernel launch (K1) and one decode+deviation
  kernel launch (K2) over all replicates; the noise of replicate b from a
  generator seeded 2000 + b. ``deviation_<dataset>.csv`` per replicate.
* ``--unconditioned`` (the ``bootstrap_*_vae_*`` scripts): the covariate
  block is a constant zero column, a plain VAE up to one bias column.
* ``analyze``: per-replicate deviation ROC-AUC per (hc, disease) label
  pair (the port's ``evaluation.metrics``, no scikit-learn), the bootstrap
  mean/std and 2.5-97.5 percentile CI, appended to
  ``result_baseline/result_bootstrap.txt``, and ``bootstrap_auc.csv``.

Each run prints its stages' walls (the test stage's by phase: prep,
restore, scoring call, CSV emit).

``--mesh R,D[,M]`` runs on a mesh of ranks (one process each, ``python -m
torch.distributed.run``; cli/bootstrap.py:194-204, :272-275 of the JAX
package): the replicates over its 'fold' axis, batch rows (and the test
stage's padded rows) over 'data', the weights over 'model' in training.
Rank 0 writes every file.

    python -m multi_modal_normative_modeling_tpu_torch.cli.bootstrap all \\
        -R ADNI -D 3modalities -B 10 -E 200 [--unconditioned] [--device cpu]
        [--checkpoint_every N [--resume]] [--mesh R,D[,M]]
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import pandas as pd
import torch

from .. import registry
from ..evaluation.metrics import roc_auc_score
from ..infer.emitters import write_csv
from ..interop import params_to_jax
from ..parallel import MultiFoldTrainer, distributed, stack_fold_batches
from ..train import TrainConfig
from ..train.checkpoints import checkpoint_exists
from . import common
from .train_supervised import EpsFn, default_init

# JAX CLI flags with no port yet: each exits instead of being ignored

# (replicate id, padded rows, latent dim) -> the scoring noise [rows, Z]
ScoreEpsFn = Callable[[int, int, int], np.ndarray]

ACTIONS = ('create_ids', 'train', 'test', 'analyze')


def _dirs(project_root: Path, unconditioned: bool):
    boot_dir = project_root / 'outputs' / 'bootstrap_analysis'
    model_name = 'supervised_vae' if unconditioned else 'supervised_cvae'
    return boot_dir, boot_dir / model_name


def _dataset_name(resource: str, dataset: str) -> str:
    if dataset == '3modalities':
        return f'early_fusion_modalities_{resource}'
    return dataset


def _prepare_all(project_root: Path, resource: str, dataset: str,
                 participants_path, id_paths) -> List[dict]:
    """prepare_modality of the bootstrap dataset for each (train ids, test
    ids or None) pair, threaded over replicates, each table parsed once;
    the early-fusion modality is built in memory from the base modalities
    when its CSV is absent (the train CLI's --in_memory_fusion)."""
    name = _dataset_name(resource, dataset)
    path = project_root / 'data' / resource / f'{name}.csv'
    fuse = name.startswith('early_fusion_modalities') and not path.exists()
    names = registry.get_datasets_name(resource) + [name] if fuse else [name]
    per_rep = common.prepare_fold_modalities(
        project_root, resource, names, participants_path, id_paths,
        fuse=fuse)
    if fuse:
        split = 'train_df' if id_paths[0][1] is None else 'test_df'
        for preps in per_rep:
            common.assert_modalities_aligned([p[split] for p in preps[:-1]],
                                             'bootstrap fusion')
    return [preps[-1] for preps in per_rep]


def create_ids(args, project_root=None, timings: Optional[dict] = None):
    """Write B bootstrap train/test id files (with-replacement train,
    out-of-bag + other-group test); on a mesh, rank 0 writes them."""
    project_root = Path(project_root) if project_root else Path.cwd()
    if distributed.rank() != 0:
        world_barrier()
        return
    boot_dir = project_root / 'outputs' / 'bootstrap_analysis'
    boot_dir.mkdir(parents=True, exist_ok=True)

    participants_path = (project_root / 'data' / args.dataset_resourse /
                         'y.csv')
    ids_df = pd.read_csv(participants_path)
    hc_label = registry.get_hc_label(args.dataset_resourse)
    training_label = hc_label if args.training_class == 'nm' else 0
    group = ids_df[ids_df['DIA'] == training_label]
    other = ids_df[ids_df['DIA'] != training_label]

    # stale replicate files from an earlier, larger -B run would otherwise
    # survive and be picked up by the train/test stages
    for old in list(boot_dir.glob('train_ids_*.csv')) + list(
            boot_dir.glob('test_ids_*.csv')):
        old.unlink()

    np.random.seed(42)
    group_ids = group['IID'].to_numpy()
    n = len(group_ids)
    size = int(n * args.oversample_percentage)
    for b in range(args.n_bootstrap):
        drawn = np.random.choice(group_ids, size=size, replace=True)
        oob = np.setdiff1d(group_ids, drawn)
        pd.DataFrame({'IID': drawn}).to_csv(
            boot_dir / f'train_ids_{b:03d}.csv', index=False)
        pd.DataFrame({'IID': np.concatenate([oob, other['IID'].to_numpy()])
                      }).to_csv(boot_dir / f'test_ids_{b:03d}.csv',
                                index=False)
    print(f'bootstrap ids: {args.n_bootstrap} replicates, {size} train draws '
          f'each, OOB + {len(other)} non-training subjects per test file '
          f'-> {boot_dir}')
    world_barrier()


def world_barrier() -> None:
    """Wait for every rank of the run's process group (if any)."""
    if torch.distributed.is_initialized():
        torch.distributed.barrier()


def _replicates(boot_dir: Path) -> List[int]:
    reps = sorted(int(p.stem.split('_')[-1])
                  for p in boot_dir.glob('train_ids_*.csv'))
    if not reps:
        raise FileNotFoundError(
            f'no bootstrap id files in {boot_dir}; run create_ids first')
    return reps


def train(args, project_root=None, init_fn: Optional[common.InitFn] = None,
          eps_fn: Optional[EpsFn] = None, timings: Optional[dict] = None):
    """Train all replicates at once as the folds of one fold-stacked model.
    ``init_fn(model)`` fills its initial weights (default: the train CLI's
    ``default_init``, the same for every replicate); ``eps_fn(valid [F, NB],
    epochs, rows, latent)`` replays the noise of every step (tests), which
    by default replicate b draws from a generator seeded 1000 + b."""
    common.require_checkpoint_for_resume(args)
    device = common.resolve_device(getattr(args, 'device', 'cuda'), 'train')
    timings = {} if timings is None else timings
    walls = common.StageWalls(timings.setdefault('walls', {}))
    project_root = Path(project_root) if project_root else Path.cwd()
    boot_dir, model_dir = _dirs(project_root, args.unconditioned)
    model_dir.mkdir(parents=True, exist_ok=True)
    participants_path = (project_root / 'data' / args.dataset_resourse /
                         'y.csv')
    reps = _replicates(boot_dir)

    with walls('train prep'):
        preps = _prepare_all(project_root, args.dataset_resourse,
                             args.dataset, participants_path,
                             [(boot_dir / f'train_ids_{b:03d}.csv', None)
                              for b in reps])
    xs = [p['train_data'] for p in preps]
    covs = [np.zeros((x.shape[0], 1), np.float32) if args.unconditioned
            else p['train_cov'] for x, p in zip(xs, preps)]

    config_dict = {
        'model': 'cVAE_multimodal',
        'input_dim_list': [int(xs[0].shape[1])],
        'hidden_dim': list(args.hz_para_list[:-1]),
        'latent_dim': int(args.hz_para_list[-1]),
        'c_dim': int(covs[0].shape[1]),
        'modalities': 1,
        'non_linear': True,
        'combine': 'gpoe',  # single modality: fusion is the M==1 shortcut
        'unconditioned': bool(args.unconditioned),
    }
    tconfig = TrainConfig(epochs=args.epochs, batch_size=256,
                          learning_rate=0.0001, combine='gpoe',
                          shuffle=False, seed=42)
    n_reps = len(reps)
    # replicates over the mesh's 'fold' axis, batch rows over 'data'
    mesh, shardings_fn = common.parse_mesh(getattr(args, 'mesh', None),
                                           n_reps, tconfig.batch_size,
                                           device)
    if mesh is not None:
        device = mesh.device
        common.announce_mesh(mesh, 'bootstrap train')
    model = common.build_model_from_config(config_dict, folds=n_reps)
    if init_fn is not None:
        init_fn(model)
    else:
        default_init(model, config_dict['model'])
    model.to(device)
    batches = stack_fold_batches([[x] for x in xs], [[c] for c in covs],
                                 tconfig.batch_size)
    draws = {'seeds': [1000 + b for b in reps]}
    if eps_fn is not None:
        draws['eps'] = eps_fn(batches['valid'], tconfig.epochs,
                              tconfig.batch_size, model.noise_dim)
    trainer = MultiFoldTrainer(model, tconfig, xs[0].shape[0], mesh=mesh,
                               shardings_fn=shardings_fn)
    resumable = common.Resumable(args)
    with walls('train run'):
        # one whole-run train state over the stacked replicate axis
        logs = resumable.run(trainer, batches, state_dir=model_dir, **draws)
    timings['train_steps'] = ((tconfig.epochs - resumable.resumed_from)
                              * batches['mask'].shape[1])
    if not common.primary(mesh):
        mesh.barrier()   # rank 0 writes the checkpoints
        return
    with walls('train artifacts'):
        per_rep = [params_to_jax(model, fold=i) for i in range(n_reps)]
        per_rep_logs = [{k: v[i] for k, v in logs.items()}
                        for i in range(n_reps)]
        # dirs keyed by replicate id, not position: the id set may be
        # non-contiguous and test()/analyze() look dirs up by id
        common.emit_fold_artifacts(model_dir, per_rep_logs, per_rep,
                                   config_dict, n_reps, fold_ids=reps)
    finals = {k: float(np.asarray(v)[:, -1].mean()) for k, v in logs.items()}
    print(f'bootstrap train: {n_reps} replicates x {args.epochs} epochs '
          f'(one fold-stacked model), final-epoch means: '
          + ', '.join(f'{k}: {v:.3f}' for k, v in sorted(finals.items())))
    common.barrier(mesh)


def default_score_eps(replicate: int, padded_rows: int,
                      z_dim: int) -> np.ndarray:
    """Replicate ``replicate``'s scoring noise: a torch.Generator seeded
    2000 + replicate (the JAX package draws from PRNGKey(2000 + b); tests
    replay those draws through ``eps_fn``)."""
    return common.seeded_eps(2000 + replicate, padded_rows, z_dim)


def score_inputs(args, project_root, device, eps_fn: ScoreEpsFn = None,
                 mesh=None):
    """What the test stage's scoring call takes: (jobs, model, xes, cs,
    eps). ``jobs`` holds per replicate its id, dir, float32 test rows
    ``x`` and test frame ``df``; ``model`` every replicate's checkpoint as
    one fold each; ``xes`` [B, rows, D] and ``cs`` [B, rows, C] the test
    rows padded to the 64-row bucket; ``eps`` [B, rows, Z]. On a ``mesh``
    the model, xes, cs and eps are this rank's replicates and rows."""
    eps_fn = eps_fn or default_score_eps
    project_root = Path(project_root)
    boot_dir, model_dir = _dirs(project_root, args.unconditioned)
    participants_path = (project_root / 'data' / args.dataset_resourse /
                         'y.csv')
    reps = _replicates(boot_dir)
    for b in reps:
        if not checkpoint_exists(model_dir / f'{b:03d}'):
            raise FileNotFoundError(
                f'no checkpoint in {model_dir / f"{b:03d}"}; run the train '
                'stage first')
    preps = _prepare_all(project_root, args.dataset_resourse, args.dataset,
                         participants_path,
                         [(boot_dir / f'train_ids_{b:03d}.csv',
                           boot_dir / f'test_ids_{b:03d}.csv') for b in reps])
    jobs = []
    for b, prep in zip(reps, preps):
        cov = (np.zeros((prep['test_data'].shape[0], 1), np.float32)
               if args.unconditioned
               else common.require_test_cov(prep, f'bootstrap test rep {b}'))
        jobs.append({'b': b, 'dir': model_dir / f'{b:03d}',
                     'x': np.asarray(prep['test_data'], np.float32),
                     'cov': cov, 'df': prep['test_df']})
    common.check_infer_fold_axis(mesh, len(jobs), 'replicates')
    rows = common.padded_rows(max(j['x'].shape[0] for j in jobs), mesh)
    folds, part = common.mesh_parts(mesh, len(jobs), rows)
    mine = jobs[folds]
    model, _, _ = common.load_model_and_params([j['dir'] for j in mine],
                                               device)
    xes = common.stack_padded([j['x'] for j in mine], rows, device, part)
    cs = common.stack_padded([j['cov'] for j in mine], rows, device, part)
    eps = torch.from_numpy(np.ascontiguousarray(np.stack([
        np.asarray(eps_fn(j['b'], rows, model.noise_dim),
                   np.float32).reshape(rows, model.noise_dim)[part]
        for j in mine]))).to(device)
    return jobs, model, xes, cs, eps


def test(args, project_root=None, eps_fn: Optional[ScoreEpsFn] = None,
         timings: Optional[dict] = None):
    """Score every replicate's test split in one fold-stacked call; emit
    deviation_<dataset>.csv per replicate. ``eps_fn(replicate, padded rows,
    latent)`` gives the noise (default ``default_score_eps``)."""
    device = common.resolve_device(getattr(args, 'device', 'cuda'), 'score')
    # replicates over the mesh's 'fold' axis, padded rows over 'data'
    mesh = common.parse_infer_mesh(getattr(args, 'mesh', None), device)
    device = device if mesh is None else mesh.device
    timings = {} if timings is None else timings
    walls = common.StageWalls(timings.setdefault('walls', {}))
    project_root = Path(project_root) if project_root else Path.cwd()
    with walls('test prep'):
        jobs, model, xes, cs, eps = score_inputs(args, project_root, device,
                                                 eps_fn, mesh)
    with walls('test scoring call'):
        # K1, the M = 1 fusion shortcut, then K2, each over every replicate
        # (this rank's replicates and rows on a mesh)
        _, devs = model.pred_recon_fused([xes], [cs], 'gpoe', eps=eps)
        devs, = common.gather_parts(mesh, [devs[0].cpu().numpy()],
                                    len(jobs))
    timings['score_shape'] = tuple(xes.shape) + (cs.shape[2],)
    if not common.primary(mesh):
        mesh.barrier()   # rank 0 writes the CSVs
        return
    with walls('test csv emit'):
        for i, j in enumerate(jobs):
            out = j['df'][['participant_id', 'DIA', 'AGE', 'PTGENDER']].copy()
            out['Reconstruction deviation'] = devs[i, :j['x'].shape[0]]
            write_csv(j['dir'] / f'deviation_{args.dataset}.csv', out)
    print(f'bootstrap test: {len(jobs)} replicates scored '
          f'(one fold-stacked call, rows padded to {devs.shape[1]})')
    common.barrier(mesh)


def analyze(args, project_root=None, timings: Optional[dict] = None) -> dict:
    """Per-replicate deviation ROC-AUC + bootstrap CI summary (on a mesh,
    rank 0's alone: a host stage on the files)."""
    if distributed.rank() != 0:
        return None
    project_root = Path(project_root) if project_root else Path.cwd()
    boot_dir, model_dir = _dirs(project_root, args.unconditioned)
    reps = sorted(int(p.name) for p in model_dir.iterdir()
                  if p.is_dir() and p.name.isdigit()
                  and (p / f'deviation_{args.dataset}.csv').exists())
    if any(boot_dir.glob('train_ids_*.csv')):
        # only the CURRENT bootstrap set: model dirs from an earlier,
        # larger -B run may still hold deviation CSVs
        current = set(_replicates(boot_dir))
        reps = [b for b in reps if b in current]
    if not reps:
        raise FileNotFoundError(
            f'no deviation_{args.dataset}.csv under {model_dir}; '
            'run the test stage first')
    frames = [pd.read_csv(model_dir / f'{b:03d}' /
                          f'deviation_{args.dataset}.csv') for b in reps]

    hc_label = registry.get_hc_label(args.dataset_resourse)
    pairs = [p for p in registry.HC_PATIENT_COMBINATIONS[args.dataset_resourse]
             if p[0] == hc_label]
    results = {}
    rows = []
    for hc, disease in pairs:
        # (replicate, auc) pairs so a skipped replicate (OOB subset with a
        # single class) cannot shift attribution of the surviving AUCs
        rep_aucs = []
        for b, df in zip(reps, frames):
            sub = df[df['DIA'].isin([hc, disease])]
            if sub['DIA'].nunique() < 2:
                continue
            labels = (sub['DIA'] != hc).astype(int)  # nm: patient = 1
            rep_aucs.append((b, roc_auc_score(
                labels, sub['Reconstruction deviation'])))
        if not rep_aucs:
            continue
        aucs = np.asarray([a for _, a in rep_aucs])
        lo, hi = np.percentile(aucs, [2.5, 97.5])
        results[f'{hc}vs{disease}'] = {
            'n_replicates': len(aucs), 'mean': float(aucs.mean()),
            'std': float(aucs.std()), 'ci_low': float(lo),
            'ci_high': float(hi),
        }
        for b, a in rep_aucs:
            rows.append({'pair': f'{hc}vs{disease}', 'replicate': b,
                         'auc': a})

    out_dir = project_root / 'result_baseline'
    out_dir.mkdir(exist_ok=True)
    variant = 'VAE' if args.unconditioned else 'CVAE'
    with open(out_dir / 'result_bootstrap.txt', 'a') as f:
        f.write(f'Bootstrap settings: {variant}. {args.dataset_resourse} '
                f'-D {args.dataset} Epochs {args.epochs} '
                f'Replicates {len(reps)} '
                f'hz_para_list: {list(args.hz_para_list)}\n')
        for pair, r in results.items():
            f.write(f'{pair} ROC-AUC: $ {100 * r["mean"]:.2f} '
                    f'\\pm {100 * r["std"]:.2f} $ '
                    f'(95% CI [{100 * r["ci_low"]:.2f}, '
                    f'{100 * r["ci_high"]:.2f}])\n')
        f.write('\n')
    pd.DataFrame(rows).to_csv(project_root / 'bootstrap_auc.csv', index=False)
    print(f'bootstrap analyze: {len(reps)} replicates, '
          + '; '.join(f'{p}: AUC {r["mean"]:.4f} '
                      f'[{r["ci_low"]:.4f}, {r["ci_high"]:.4f}]'
                      for p, r in results.items()))
    return results


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='Bootstrap-resampled normative modeling '
                    "(the reference commands_list10.sh's bootstrap_* chain)")
    parser.add_argument('action', choices=[*ACTIONS, 'all'])
    parser.add_argument('-R', '--dataset_resourse', default='ADNI')
    parser.add_argument('-D', '--dataset', default='3modalities',
                        help="modality table; '3modalities' = the "
                             'early-fusion concat')
    parser.add_argument('-E', '--epochs', type=int, default=200)
    parser.add_argument('-B', '--n_bootstrap', type=int, default=10)
    parser.add_argument('-H', '--hz_para_list', nargs='+', type=int,
                        default=[110, 110, 10])
    parser.add_argument('-O', '--oversample_percentage', type=float,
                        default=1)
    parser.add_argument('-TrainingClass', '--training_class', default='nm')
    parser.add_argument('--device', dest='device', default='cuda',
                        help='torch device to run on (default cuda); cuda '
                             'runs the kernels, cpu their plain versions')
    parser.add_argument('--mesh', dest='mesh', default=None, metavar='R,D',
                        help='run on a mesh of ranks (one process each, '
                             'python -m torch.distributed.run): replicates '
                             "over R (the 'fold' axis), rows over D; R,D,M "
                             "adds the 'model' axis to training; rank 0 "
                             'writes every file')
    common.add_resume_flags(parser)
    parser.add_argument('--no_fused_heads', dest='no_fused_heads',
                        action='store_true',
                        help='accepted for the JAX CLI flag surface: the '
                             'port always runs the mu and logvar heads as '
                             'two products (the same math as the merged '
                             'head)')
    parser.add_argument('--unconditioned', action='store_true',
                        help='plain-VAE variant: constant zero covariates')
    return parser


def main(args=None, project_root=None, timings: Optional[dict] = None):
    """Run ``args.action`` (``all``: every action in turn). What any action
    would refuse (--resume without --checkpoint_every, no CUDA device) is
    refused before the first writes a file; with --mesh the run joins its
    process group first. ``timings``, when given, receives the stages'
    walls."""
    if args is None or isinstance(args, list):
        args = build_parser().parse_args(args)
    actions = list(ACTIONS) if args.action == 'all' else [args.action]
    if 'train' in actions:
        common.require_checkpoint_for_resume(args)
    if {'train', 'test'} & set(actions):
        device = common.resolve_device(getattr(args, 'device', 'cuda'),
                                       'run')
        if getattr(args, 'mesh', None):
            # the slots against the run's ranks before any file
            common.parse_axis_sizes(args.mesh, '--mesh', (2, 3),
                                    '2,4 or 2,2,2 (fold,data[,model])')
            distributed.initialize_distributed(device=device)
    timings = {} if timings is None else timings
    walls = common.StageWalls(timings.setdefault('walls', {}))
    result = None
    for action in actions:
        with walls(action):
            result = globals()[action](args, project_root=project_root,
                                       timings=timings)
    walls.report('bootstrap')
    return result


if __name__ == '__main__':
    main()
    distributed.shutdown()
