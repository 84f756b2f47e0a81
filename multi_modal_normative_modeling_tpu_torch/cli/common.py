"""Flags and per-fold data prep for the port's CLIs: the jax-free subset of
the JAX package's cli/common.py (add_common_flags,
apply_post_parse_defaults, prepare_modality, prepare_folds, fold_paths,
assert_modalities_aligned, require_test_cov, infer_row_tile,
model_config_dict, build_model_from_config, emit_fold_artifacts), without
its process-wide memo caches, plus the k-fold id files without sklearn.

The registry and the data layer (loading, scaling, covariate binning) are
the JAX package's own modules, which import neither jax nor flax.
"""
from __future__ import annotations

import argparse
import csv
import importlib.util
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Tuple

import numpy as np
import pandas as pd
import torch

from multi_modal_normative_modeling_tpu import registry
from multi_modal_normative_modeling_tpu.data.loading import (
    fast_inner_merge,
    load_demographic_data,
)
from multi_modal_normative_modeling_tpu.data.preprocess import (
    fit_robust_scaler,
    one_hot_covariates,
)


def resolve_device(name: str, what: str = 'run') -> torch.device:
    """The --device to run on; a CUDA device that is not there is an error,
    never a fallback to the CPU."""
    device = torch.device(name)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise SystemExit(f'--device {name}: no CUDA device is available '
                         f'(pass --device cpu to {what} with the plain torch '
                         'versions of the kernels)')
    return device


def add_common_flags(parser: argparse.ArgumentParser,
                     default_n_splits: int = 10) -> argparse.ArgumentParser:
    """The -R/-H/-C/-P/-E/-K/-O/-Model/... flags of the reference scripts
    (multimodal_kfold_train_cvae_supervised.py:216-286)."""
    parser.add_argument('-R', '--dataset_resourse', dest='dataset_resourse',
                        type=str,
                        help='Dataset to use for training test and evaluation.')
    parser.add_argument('-H', '--hz_para_list', dest='hz_para_list', nargs='+',
                        type=int, help='List of paras to perform the analysis.')
    parser.add_argument('-C', '--combine', dest='combine', type=str,
                        help='how do we combine all modalities.')
    parser.add_argument('-P', '--procedure', dest='procedure', type=str,
                        help='Procedure to perform the analysis.')
    parser.add_argument('-E', '--epochs', dest='epochs', type=int,
                        help='Number of epochs to train the model.')
    parser.add_argument('-K', '--n_splits', dest='n_splits', type=int,
                        default=default_n_splits,
                        help='Number of splits for k-fold cross-validation.')
    parser.add_argument('-O', '--oversample_percentage',
                        dest='oversample_percentage', type=float, default=1,
                        help='Percentage of oversampling of the training data.')
    parser.add_argument('-Model', '--model', dest='model',
                        default='cVAE_multimodal', type=str,
                        help='Model to use for training the data.')
    parser.add_argument('-SingleModality', '--single_modality',
                        dest='single_modality', default=None, type=str,
                        help='Single modality to use for training the data.')
    parser.add_argument('-Baselearningrate', '--base_learning_rate',
                        dest='base_learning_rate', type=float, default=0.0001,
                        help='Base learning rate for the model.')
    parser.add_argument('-Maxlearningrate', '--max_learning_rate',
                        dest='max_learning_rate', type=float, default=0.005,
                        help='Max learning rate for the model.')
    parser.add_argument('-TrainingClass', '--training_class',
                        dest='training_class', default='nm', type=str,
                        help='Class to train the model.')
    return parser


def apply_post_parse_defaults(args, default_procedure: str = 'UCA-gPoE',
                              default_epochs: int = 200):
    """Reference post-parse defaulting (train:288-297)."""
    if getattr(args, 'hz_para_list', None) is None:
        args.hz_para_list = [110, 110, 10]
    if getattr(args, 'procedure', None) is None:
        args.procedure = default_procedure
    if getattr(args, 'combine', None) is None:
        args.combine = args.procedure.split('-')[1]
    if getattr(args, 'dataset_resourse', None) is None:
        args.dataset_resourse = 'ADNI'
    if getattr(args, 'epochs', None) is None:
        args.epochs = default_epochs
    return args


def kfold_split(n_samples: int, n_splits: int, random_state: int = 42):
    """(train_idx, test_idx) per fold, as sklearn's
    KFold(n_splits, shuffle=True, random_state).split yields them: a
    RandomState(random_state) shuffle, the first n % k folds one longer,
    both index sets ascending. The JAX package's fold-id writer calls
    sklearn, which the GPU machine does not have."""
    if not 2 <= n_splits <= n_samples:
        raise ValueError(f'cannot split {n_samples} samples into {n_splits} '
                         'folds')
    indices = np.arange(n_samples)
    np.random.RandomState(random_state).shuffle(indices)
    sizes = np.full(n_splits, n_samples // n_splits, dtype=int)
    sizes[:n_samples % n_splits] += 1
    start = 0
    for size in sizes:
        test = np.zeros(n_samples, dtype=bool)
        test[indices[start:start + size]] = True
        start += size
        yield np.flatnonzero(~test), np.flatnonzero(test)


def generate_kfold_ids(hc_group, other_group, oversample_percentage=1,
                       n_splits=5, project_root=None) -> None:
    """data/loading.generate_kfold_ids without sklearn: the same split of
    both groups' concatenation, the same oversampling draws from numpy's
    global stream, the same train_ids_NNN.csv / test_ids_NNN.csv."""
    root = Path(project_root) if project_root else Path.cwd()
    kfold_dir = root / 'outputs' / 'kfold_analysis'
    kfold_dir.mkdir(parents=True, exist_ok=True)
    full_group = pd.concat([hc_group, other_group])
    for fold, (train_idx, test_idx) in enumerate(
            kfold_split(len(full_group), n_splits)):
        train_ids = full_group.iloc[train_idx]['IID']
        test_ids = full_group.iloc[test_idx]['IID']
        size = int(len(train_ids) * oversample_percentage)
        oversampled = np.random.choice(train_ids, size=size, replace=True)
        pd.DataFrame({'IID': oversampled}).to_csv(
            kfold_dir / f'train_ids_{fold:03d}.csv', index=False)
        pd.DataFrame({'IID': test_ids}).to_csv(
            kfold_dir / f'test_ids_{fold:03d}.csv', index=False)


# The JAX package parses modality tables of at least this many columns with
# its native loader, which rounds every value correctly; pandas' default
# parser may differ by 1 ulp, its round-trip parser does not.
_WIDE_TABLE_COLS = 256


def read_csv(path) -> pd.DataFrame:
    """pd.read_csv, parsing wide modality tables exactly as the JAX package
    does, so both packages scale identical values."""
    with open(path, newline="") as f:
        header = next(csv.reader(f))
    if "IID" in header and len(header) >= _WIDE_TABLE_COLS:
        return pd.read_csv(path, float_precision="round_trip")
    return pd.read_csv(path)


def load_dataset(demographic_path, ids_path, modality_path,
                 read=read_csv) -> pd.DataFrame:
    """Merge a modality table with the demographic rows of ``ids_path``
    (cli/common.py::load_dataset_cached of the JAX package). ``read`` gives
    the demographic and modality tables; the test stage passes a lookup of
    tables it parsed once, so k folds share them."""
    demographic_df = read(demographic_path).dropna()
    ids_df = pd.read_csv(ids_path, usecols=['IID'])
    if ('Run_ID' in demographic_df.columns
            or 'Session_ID' in demographic_df.columns):
        # composite id formats: the reference-exact loader
        demographic = load_demographic_data(demographic_path, ids_path)
    else:
        ids_df = ids_df.copy()
        if 'participant_id' not in demographic_df.columns:
            ids_df['participant_id'] = ids_df['IID']
        demographic = fast_inner_merge(ids_df, demographic_df, on='IID')
    return fast_inner_merge(read(modality_path), demographic, on='IID')


def shared_tables(pool, project_root: Path, resource: str,
                  dataset_names: List[str], participants_path):
    """Parse the demographic table and each modality table once, on
    ``pool``, and return the ``read`` lookup that prepare_modality takes:
    every fold merges the same tables, so k folds share the frames
    (read-only)."""
    paths = [participants_path] + [
        Path(project_root) / 'data' / resource / f'{name}.csv'
        for name in dataset_names]
    return dict(zip(paths, pool.map(read_csv, paths))).__getitem__


def prepare_modality(project_root: Path, resource: str, dataset_name: str,
                     participants_path, train_ids_path,
                     test_ids_path=None, read=read_csv) -> dict:
    """Load + scale one modality for a fold, reference test/train semantics:
    RobustScaler fit on the fold's train rows, applied to both splits;
    qcut one-hot covariates fit independently per split (SURVEY.md Q5)."""
    columns_name = registry.get_column_name(resource, dataset_name)
    modality_path = (Path(project_root) / 'data' / resource
                     / f'{dataset_name}.csv')
    train_df = load_dataset(participants_path, train_ids_path, modality_path,
                            read)
    train_data, scaler = fit_robust_scaler(train_df[columns_name].values)
    out = {
        'columns': columns_name,
        'train_df': train_df,
        'train_data': train_data.astype(np.float32),
        'train_cov': one_hot_covariates(train_df[['DIA', 'PTGENDER', 'AGE']]),
        'scaler': scaler,
    }
    if test_ids_path is not None:
        test_df = load_dataset(participants_path, test_ids_path,
                               modality_path, read)
        out['test_df'] = test_df
        # float64, like the reference's scaled DataFrame (test:90); the
        # device path downcasts to float32
        out['test_data'] = scaler.transform(test_df[columns_name].values)
        try:
            out['test_cov'] = one_hot_covariates(
                test_df[['DIA', 'AGE', 'PTGENDER']])
        except ValueError as e:
            # fewer test rows than qcut bins: keep the reason for
            # require_test_cov
            out['test_cov'] = None
            out['test_cov_error'] = str(e)
    return out


def assert_modalities_aligned(frames, context: str,
                              key: str = 'participant_id') -> None:
    """Every modality's merged frame must cover the same subjects in the
    same order: the stacked inference pairs modality-0 row indices and
    participant ids with the LAST modality's covariates (reference test:102
    semantics)."""
    base = frames[0][key].to_numpy()
    for i, frame in enumerate(frames[1:], 1):
        cur = frame[key].to_numpy()
        if len(cur) != len(base) or not (cur == base).all():
            raise ValueError(
                f"{context}: modality row sets/orders differ between "
                f"modality 0 ({len(base)} rows) and modality {i} "
                f"({len(cur)} rows); every modality CSV must cover the "
                "same subjects in the same order")


def require_test_cov(prep: dict, context: str) -> np.ndarray:
    """A prep's qcut test covariates, or the original qcut error."""
    cov = prep.get('test_cov')
    if cov is None:
        raise ValueError(
            f"{context}: test covariates unavailable — "
            f"{prep.get('test_cov_error', 'qcut binning failed')}. "
            "The k-fold test stage needs >= bin-count test rows per fold.")
    return cov


def fold_paths(kfold_dir: Path, fold: int) -> Tuple[Path, Path]:
    return (kfold_dir / f'train_ids_{fold:03d}.csv',
            kfold_dir / f'test_ids_{fold:03d}.csv')


def infer_row_tile() -> int:
    """Row-padding bucket of the scoring call (the JAX package's, without a
    mesh): every fold is padded to the same multiple of it, so the padded
    rows, and with them the eps draw of each fold, match the JAX stage."""
    return 64


def prepare_folds(args, project_root: Path, kfold_dir: Path, model_dir: Path,
                  dataset_names: List[str], participants_path):
    """Per-fold train-split prep for the trainer (host side, threaded over
    fold x modality). Creates the per-fold model dirs and returns
    ``(folds, input_dim_list, c_dim)`` where ``folds`` is a list of
    ``(data_list, cov_list)`` per fold."""
    train_paths = []
    for fold in range(args.n_splits):
        train_ids_path, _ = fold_paths(kfold_dir, fold)
        (model_dir / f'{fold:03d}').mkdir(exist_ok=True, parents=True)
        train_paths.append(train_ids_path)
    jobs = [(ids, name) for ids in train_paths for name in dataset_names]
    with ThreadPoolExecutor(max_workers=8) as pool:
        read = shared_tables(pool, project_root, args.dataset_resourse,
                             dataset_names, participants_path)
        preps = list(pool.map(
            lambda job: prepare_modality(project_root, args.dataset_resourse,
                                         job[1], participants_path, job[0],
                                         read=read), jobs))
    n_mod = len(dataset_names)
    folds = []
    for f in range(args.n_splits):
        fold_preps = preps[f * n_mod:(f + 1) * n_mod]
        folds.append(([p['train_data'] for p in fold_preps],
                      [p['train_cov'] for p in fold_preps]))
    input_dim_list = [p['train_data'].shape[1] for p in preps[:n_mod]]
    c_dim = preps[0]['train_cov'].shape[1]
    return folds, input_dim_list, c_dim


def model_config_dict(args, input_dim_list: List[int], c_dim: int,
                      modalities: int) -> dict:
    return {
        'model': args.model,
        'input_dim_list': list(map(int, input_dim_list)),
        'hidden_dim': list(args.hz_para_list[:-1]),
        'latent_dim': int(args.hz_para_list[-1]),
        'c_dim': int(c_dim),
        'modalities': int(modalities),
        'non_linear': True,
        'combine': args.combine,
    }


def build_model_from_config(config: dict, folds: int = 1, device=None,
                            generator=None):
    """The model a checkpoint's cVAE_model.json describes, holding
    ``folds`` folds."""
    from ..models import build_model

    return build_model(
        config['model'], config['input_dim_list'], config['hidden_dim'],
        config['latent_dim'], config['c_dim'], config['modalities'],
        config.get('non_linear', True), folds=folds, generator=generator,
        device=device,
    )


def emit_fold_artifacts(model_dir: Path, per_fold_logs, per_fold_params,
                        model_config: dict, n_folds: int) -> None:
    """Per-fold loss plot and checkpoint into ``model_dir/NNN``, threaded
    over folds (the checkpoint writer is atomic; plot_losses uses no pyplot
    state). Without matplotlib the plots are skipped, and said so; the
    checkpoints are always written."""
    from multi_modal_normative_modeling_tpu.utils.logging import (
        Logger,
        plot_losses,
    )

    from ..train.checkpoints import save_checkpoint

    plot = importlib.util.find_spec('matplotlib') is not None
    if not plot:
        print('matplotlib is not installed: skipping the loss plots '
              '(Losses*.png); checkpoints and the run log are written')

    def emit(i):
        fold_dir = model_dir / f'{i:03d}'
        fold_dir.mkdir(parents=True, exist_ok=True)
        if plot:
            logger = Logger()
            logger.extend(per_fold_logs[i])
            plot_losses(logger, fold_dir, 'training')
        save_checkpoint(fold_dir, per_fold_params[i], model_config)

    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(emit, range(n_folds)))
