"""Flags and per-fold data prep for the port's CLIs: the jax-free subset of
the JAX package's cli/common.py (add_common_flags,
apply_post_parse_defaults, prepare_modality, prepare_fold_modalities,
prepare_folds, fuse_preps, fold_paths,
assert_modalities_aligned, require_test_cov, infer_row_tile,
uniform_covariates, model_config_dict, build_model_from_config,
load_model_and_params, emit_fold_artifacts, add_resume_flags,
require_checkpoint_for_resume) and its native read path (``read_csv``
through native/fastcsv, ``fast_path_reasons``), without its process-wide
memo caches, plus the k-fold id files without sklearn.

The registry and the data layer (loading, scaling, covariate binning) are
the port's own copies (``registry``, ``data/``) of the JAX package's
jax-free modules; nothing here imports that package.
"""
from __future__ import annotations

import argparse
import contextlib
import csv
import importlib.util
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from .. import registry
from ..data.loading import fast_inner_merge, load_demographic_data
from ..data.preprocess import fit_robust_scaler, one_hot_covariates


def resolve_device(name: str, what: str = 'run') -> torch.device:
    """The --device to run on; a CUDA device that is not there is an error,
    never a fallback to the CPU."""
    device = torch.device(name)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise SystemExit(f'--device {name}: no CUDA device is available '
                         f'(pass --device cpu to {what} with the plain torch '
                         'versions of the kernels)')
    return device


# the JAX variant CLIs' flags with no port yet, each with the queue 1 item
# that ports it (ROADMAP.md); the port raises instead of ignoring them
VARIANT_NOT_PORTED = {
    'packed_xla': "queue 1 items 'Packed layout' and 'Grouped layout'",
    'ep_mesh': "queue 1 item 'Multi-device'",
    'mesh': "queue 1 item 'Multi-device'",
}


def add_variant_flags(parser: argparse.ArgumentParser,
                      not_ported: Sequence[str]) -> None:
    """--device, the no-op --fold_parallel, --checkpoint_every/--resume,
    and the named flags of VARIANT_NOT_PORTED with the JAX CLIs' dests and
    defaults."""
    parser.add_argument('--device', dest='device', default='cuda',
                        help='torch device to run on (default cuda); cuda '
                             'runs the kernels, cpu their plain versions')
    parser.add_argument('--fold_parallel', dest='fold_parallel',
                        action='store_true',
                        help='accepted for the JAX CLI flag surface: the '
                             'port always trains every fold at once')
    kinds = {'packed_xla': {'action': 'store_true'},
             'ep_mesh': {'default': None},
             'mesh': {'default': None}}
    for flag in not_ported:
        parser.add_argument(f'--{flag}', dest=flag,
                            help='not ported yet (raises); see ROADMAP.md',
                            **kinds[flag])
    add_resume_flags(parser)


def refuse_not_ported(args, what: str,
                      flags: Dict[str, str] = VARIANT_NOT_PORTED) -> None:
    """Exit, citing its queue item, on any of ``flags`` set ({flag: queue
    item}; VARIANT_NOT_PORTED by default)."""
    for flag, item in flags.items():
        if getattr(args, flag, None):
            raise SystemExit(f'--{flag} is not ported to the torch {what} '
                             f'yet; see ROADMAP.md, {item}')


def add_resume_flags(parser: argparse.ArgumentParser) -> None:
    """--checkpoint_every/--resume of every trainer CLI (cli/common.py:744-
    755 of the JAX package)."""
    parser.add_argument('--checkpoint_every', dest='checkpoint_every',
                        type=int, default=0, metavar='N',
                        help='write a resumable train-state checkpoint '
                             '(params + optimizer state + PRNG + epoch '
                             'cursor) every N epochs; chunked execution is '
                             'bit-identical to the single-scan run')
    parser.add_argument('--resume', dest='resume', action='store_true',
                        help='resume a killed run from its train-state '
                             'checkpoint (requires --checkpoint_every)')


def require_checkpoint_for_resume(args) -> None:
    """--resume without --checkpoint_every would silently retrain from
    scratch (the resumable branch is never taken): refuse instead, before
    any file is written."""
    if getattr(args, 'resume', False) and not (
            getattr(args, 'checkpoint_every', 0) or 0):
        raise SystemExit(
            '--resume requires --checkpoint_every N: a resumable train '
            'state is only written (and read) when checkpointing is on')


class Resumable:
    """--checkpoint_every/--resume of one CLI run: ``run`` calls a
    trainer's ``run`` without checkpoints, else its ``run_resumable`` with
    one whole-run train state under ``state_dir``; there is no fallback
    from one to the other."""

    def __init__(self, args):
        self.every = getattr(args, 'checkpoint_every', 0) or 0
        self.resume = getattr(args, 'resume', False)
        self.resumed_from = 0

    def run(self, trainer, *run_args, state_dir: Path, **kwargs):
        if not self.every:
            return trainer.run(*run_args, **kwargs)
        out = trainer.run_resumable(*run_args, state_dir=state_dir,
                                    checkpoint_every=self.every,
                                    resume=self.resume, **kwargs)
        self.resumed_from = trainer.resumed_from
        if self.resumed_from:
            print(f'resumed from the train state at epoch '
                  f'{self.resumed_from} ({state_dir})')
        return out

    def fields(self) -> dict:
        """The run log's account of it (nothing without checkpoints)."""
        if not self.every:
            return {}
        return {'checkpoint_every': self.every,
                'resumed_from': self.resumed_from}


# the variant CLIs' test hooks: the fold-stacked model's initial weights,
# and (valid [F, NB], epochs, batch rows, model) -> MultiFoldTrainer.run's
# replayed draws {eps, keeps, perms}
InitFn = Callable[[torch.nn.Module], None]
DrawsFn = Callable[[np.ndarray, int, int, torch.nn.Module], dict]


class StageWalls:
    """Host wall time of a CLI's stages: ``with walls('train'):`` times
    one; ``report`` prints them all. ``record``, when given, receives the
    times too (chip_smoke.py reads them there). With ``accumulate`` a
    stage entered again adds to its time (a sweep's per-point stages)."""

    def __init__(self, record: Optional[dict] = None,
                 accumulate: bool = False):
        self.walls: Dict[str, float] = {} if record is None else record
        self.accumulate = accumulate

    @contextlib.contextmanager
    def __call__(self, stage: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            spent = time.perf_counter() - start
            if self.accumulate:
                spent += self.walls.get(stage, 0.0)
            self.walls[stage] = spent

    def report(self, what: str) -> None:
        print(f'{what} stage walls: ' + ', '.join(
            f'{k} {v:.3f} s' for k, v in self.walls.items()), flush=True)


def seeded_eps(seed: int, rows: int, z_dim: int) -> np.ndarray:
    """Scoring noise [rows, z_dim] from a torch.Generator seeded ``seed``
    (the JAX package draws from PRNGKey(seed); the streams differ, tests
    replay the JAX draws through a CLI's ``eps_fn``)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((rows, z_dim), generator=gen).numpy()


def init_from_one_fold(model, one) -> None:
    """Every fold of ``model`` starts from the weights (and buffers) of
    ``one``, a folds=1 model of the same architecture: the reference
    re-seeds 42 per fold, so every fold's init is the same draw."""
    model.load_state_dict({
        k: v.expand((model.folds,) + v.shape[1:]).clone()
        for k, v in one.state_dict().items()})


def stack_padded(arrays: Sequence[np.ndarray], rows: int,
                 device) -> torch.Tensor:
    """[len(arrays), rows, width] float32 on ``device``: each array's rows
    first, zero rows after (rows are independent through every model)."""
    out = np.zeros((len(arrays), rows, arrays[0].shape[1]), np.float32)
    for i, a in enumerate(arrays):
        out[i, :a.shape[0]] = a
    return torch.from_numpy(out).to(device)


def padded_rows(n: int) -> int:
    """``n`` rows padded to the scoring call's bucket (infer_row_tile)."""
    tile = infer_row_tile()
    return -(-n // tile) * tile


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


def _write_fold_ids(kfold_dir: Path, split_frame: pd.DataFrame,
                    oversample_percentage: float, n_splits: int,
                    random_state: int = 42) -> None:
    """data/loading.py::_write_fold_ids without sklearn: the KFold split of
    ``split_frame``, the oversampling draws from numpy's global stream, one
    train_ids_NNN.csv / test_ids_NNN.csv pair per fold."""
    kfold_dir.mkdir(parents=True, exist_ok=True)
    for fold, (train_idx, test_idx) in enumerate(
            kfold_split(len(split_frame), n_splits, random_state)):
        train_ids = split_frame.iloc[train_idx]['IID']
        test_ids = split_frame.iloc[test_idx]['IID']
        size = int(len(train_ids) * oversample_percentage)
        oversampled = np.random.choice(train_ids, size=size, replace=True)
        pd.DataFrame({'IID': oversampled}).to_csv(
            kfold_dir / f'train_ids_{fold:03d}.csv', index=False)
        pd.DataFrame({'IID': test_ids}).to_csv(
            kfold_dir / f'test_ids_{fold:03d}.csv', index=False)


def generate_kfold_ids(hc_group, other_group, oversample_percentage=1,
                       n_splits=5, project_root=None) -> None:
    """data/loading.generate_kfold_ids without sklearn: the split of both
    groups' concatenation into outputs/kfold_analysis."""
    root = Path(project_root) if project_root else Path.cwd()
    _write_fold_ids(root / 'outputs' / 'kfold_analysis',
                    pd.concat([hc_group, other_group]),
                    oversample_percentage, n_splits)


def generate_kfold_ids_endtoend(hc_group, other_group,
                                oversample_percentage=1, n_splits=5,
                                random_state=42, project_root=None) -> None:
    """data/loading.generate_kfold_ids_endtoend without sklearn: the same
    split as ``generate_kfold_ids``, written to
    outputs/kfold_analysis_endtoend (utils.py:19-42)."""
    root = Path(project_root) if project_root else Path.cwd()
    _write_fold_ids(root / 'outputs' / 'kfold_analysis_endtoend',
                    pd.concat([hc_group, other_group]),
                    oversample_percentage, n_splits, random_state)


# Wide numeric tables (PPMI is 3485 columns) parse ~6x faster through the
# native loader; below this width pandas' fixed overhead doesn't matter.
_FASTCSV_MIN_COLS = 256

_log = logging.getLogger("mmnm.data")
# why the native fast path disengaged, per path -> (mtime_ns, reason): a
# user-visible signal + skips re-attempting the native parse for files known
# to need pandas. Keyed by mtime, so a rewritten (fixed) file gets the fast
# path back.
fast_path_reasons: dict = {}


def _mtime(path) -> int:
    try:
        return Path(path).stat().st_mtime_ns
    except OSError:
        return -1


def _fast_path_off(path, reason: str, level=None) -> None:
    key = str(path)
    entry = (_mtime(path), reason)
    if fast_path_reasons.get(key) != entry:
        fast_path_reasons[key] = entry
        (level or _log.info)("fastcsv fast path disabled for %s: %s",
                             key, reason)


def _read_modality_fast(path) -> "pd.DataFrame | None":
    """Parse an IID + all-numeric-columns table with the native fastcsv
    loader (or return None to fall back to pandas, logging why on
    'mmnm.data'). Values are correctly rounded (std::from_chars); pandas'
    default parser may differ by 1 ulp. Quoted fields are fully supported
    (RFC4180 incl. embedded newlines; quote-parity row index)."""
    memo = fast_path_reasons.get(str(path))
    if memo is not None:
        if memo[0] == _mtime(path):
            return None  # known to need pandas; don't re-parse natively
        del fast_path_reasons[str(path)]  # file changed: retry natively
    try:
        from ..native.fastcsv import FastCSV, fastcsv_available
    except Exception:
        _fast_path_off(path, "native loader import failed")
        return None
    if not fastcsv_available():
        _fast_path_off(path, "no C++ toolchain: native library unavailable")
        return None

    with open(path, newline="") as f:
        header = next(csv.reader(f))
    if "IID" not in header:
        return None  # not a modality table; silently use pandas
    if len(header) < _FASTCSV_MIN_COLS:
        _fast_path_off(
            path, f"narrow table ({len(header)} cols < {_FASTCSV_MIN_COLS}): "
            "pandas fixed overhead is negligible here", _log.debug)
        return None
    value_cols = [c for c in header if c != "IID"]
    try:
        reader = FastCSV(path)
        try:
            ids = reader.read_string_column("IID")
            values = reader.read_columns(value_cols)
        finally:
            reader.close()
    except Exception as exc:
        # e.g. unreadable/degenerate file: never let the fast path be a
        # correctness hazard — pandas decides what the file really is
        _fast_path_off(path, f"native parse failed ({exc!r}): "
                             "deferring to pandas")
        return None
    if np.isnan(values).any():
        # non-numeric or missing cells: pandas' dtype inference is needed.
        # Memoized, so the file is natively parsed at most once.
        _fast_path_off(path, "non-numeric or missing cells detected: "
                             "deferring to pandas dtype inference")
        return None
    frame = pd.DataFrame(values, columns=value_cols)
    frame.insert(header.index("IID"), "IID", ids)
    return frame


def read_csv(path) -> pd.DataFrame:
    """A demographic or modality table, as the JAX package's
    read_csv_cached parses it: wide modality tables through the native C++
    loader (native/fastcsv.cpp), everything else, and any table the loader
    refuses (see ``fast_path_reasons``), through pd.read_csv."""
    frame = _read_modality_fast(path)
    return pd.read_csv(path) if frame is None else frame


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


def fuse_preps(base_preps: List[dict], base_names: List[str],
               resource: str) -> dict:
    """Build the UCA early-fusion modality by concatenating the base
    modalities' already-scaled matrices in memory, instead of reading the
    early_fusion_modalities_<resource>.csv (cli/common.py:445-475 of the
    JAX package).

    Numerically identical to the file-based path: RobustScaler is
    per-column, so scaling the concatenated raw table fit on the same train
    rows equals concatenating the per-modality scaled blocks; row order
    follows the base modality CSVs exactly like the offline table writer
    (cli/early_fusion.py asserts shared IID order).
    """
    columns = []
    for prep, name in zip(base_preps, base_names):
        columns += [f"{c}_{name}" for c in prep['columns']]
    fused = {
        'columns': columns,
        'train_df': base_preps[0]['train_df'],
        'train_data': np.concatenate(
            [p['train_data'] for p in base_preps], axis=1),
        'train_cov': base_preps[-1]['train_cov'],
    }
    if 'test_data' in base_preps[0]:
        fused['test_df'] = base_preps[0]['test_df']
        fused['test_data'] = np.concatenate(
            [p['test_data'] for p in base_preps], axis=1)
        fused['test_cov'] = base_preps[-1]['test_cov']
        if 'test_cov_error' in base_preps[-1]:
            # preserve the qcut failure reason for require_test_cov
            fused['test_cov_error'] = base_preps[-1]['test_cov_error']
    return fused


def in_memory_fusion(args) -> bool:
    """Whether ``args`` builds the UCA early-fusion modality in memory
    (--in_memory_fusion on a UCA procedure; other procedures have no fused
    modality and ignore the flag, as in the JAX package)."""
    return bool(getattr(args, 'in_memory_fusion', False)
                and args.procedure.startswith('UCA'))


def prepare_fold_modalities(project_root: Path, resource: str,
                            dataset_names: Sequence[str], participants_path,
                            id_paths, fuse: bool = False,
                            walls: Optional[StageWalls] = None
                            ) -> List[List[dict]]:
    """prepare_modality of every (fold, modality), threaded over both, each
    table parsed once and shared by the folds (read-only). ``id_paths``
    holds one (train ids path, test ids path or None) pair per fold. With
    ``fuse`` the last name (the early-fusion table) is not read: its prep
    is ``fuse_preps`` of the others'. ``walls``, when given, times the
    tables' parse ('csv parse') and the merge, scaling and binning
    ('prep'). Returns one list of preps per fold, in modality order."""
    walls = walls or StageWalls()
    load_names = list(dataset_names[:-1] if fuse else dataset_names)
    jobs = [(paths, name) for paths in id_paths for name in load_names]
    with ThreadPoolExecutor(max_workers=8) as pool:
        with walls('csv parse'):
            read = shared_tables(pool, project_root, resource, load_names,
                                 participants_path)
        with walls('prep'):
            preps = list(pool.map(
                lambda job: prepare_modality(project_root, resource, job[1],
                                             participants_path, *job[0],
                                             read=read), jobs))
            n_mod = len(load_names)
            per_fold = [preps[i * n_mod:(i + 1) * n_mod]
                        for i in range(len(id_paths))]
            if fuse:
                for fold_preps in per_fold:
                    fold_preps.append(fuse_preps(fold_preps, load_names,
                                                 resource))
    return per_fold


def prepare_folds(args, project_root: Path, kfold_dir: Path, model_dir: Path,
                  dataset_names: List[str], participants_path):
    """Per-fold train-split prep for the trainer (host side, threaded over
    fold x modality). Creates the per-fold model dirs and returns
    ``(folds, input_dim_list, c_dim)`` where ``folds`` is a list of
    ``(data_list, cov_list)`` per fold. With ``in_memory_fusion(args)`` the
    early-fusion modality is built from the scaled base blocks
    (``fuse_preps``) instead of read from its CSV."""
    for fold in range(args.n_splits):
        (model_dir / f'{fold:03d}').mkdir(exist_ok=True, parents=True)
    fold_preps = prepare_fold_modalities(
        project_root, args.dataset_resourse, dataset_names, participants_path,
        [(fold_paths(kfold_dir, fold)[0], None)
         for fold in range(args.n_splits)], fuse=in_memory_fusion(args))
    folds = [([p['train_data'] for p in preps],
              [p['train_cov'] for p in preps]) for preps in fold_preps]
    input_dim_list = [p['train_data'].shape[1] for p in fold_preps[0]]
    c_dim = fold_preps[0][0]['train_cov'].shape[1]
    return folds, input_dim_list, c_dim


def uniform_covariates(folds):
    """None when every fold's per-modality covariate blocks are identical,
    else the reason. The packed layouts feed one covariate block to every
    modality, which is only equivalent to the per-modality path when the
    blocks match (they do whenever the modality CSVs share row order)."""
    for _, cov_list in folds:
        first = cov_list[0]
        for c in cov_list[1:]:
            if c.shape != first.shape or not np.array_equal(c, first):
                return ('per-modality covariates differ across modalities '
                        '(packed layout shares one block)')
    return None


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


def load_model_and_params(fold_dirs: Sequence[Path], device=None):
    """Restore (model, params, config) from fold checkpoint dirs (the JAX
    package's load_model_and_params, with the fold axis written out):
    ``model`` holds one fold per dir, in order, on ``device``; ``params``
    is their JAX-layout tree stacked on a leading fold axis; ``config`` is
    the first dir's cVAE_model.json, which every other dir must repeat."""
    from ..interop import params_from_jax, read_flax_checkpoint
    from ..parallel import stack_params

    params_list, config = [], None
    for fold_dir in fold_dirs:
        params, fold_config = read_flax_checkpoint(fold_dir)
        if config is None:
            config = fold_config
        elif fold_config != config:
            raise ValueError(f'{fold_dir}: cVAE_model.json {fold_config} '
                             f'differs from the first fold\'s {config}')
        params_list.append(params)
    params = stack_params(params_list)
    model = build_model_from_config(config, folds=len(params_list))
    params_from_jax(params, model, device)
    return model, params, config


def emit_fold_artifacts(model_dir: Path, per_fold_logs, per_fold_params,
                        model_config: dict, n_folds: int,
                        plot: bool = True, fold_ids=None) -> None:
    """Per-fold loss plot and checkpoint into ``model_dir/NNN``, threaded
    over folds (the checkpoint writer is atomic; plot_losses uses no pyplot
    state). Without matplotlib, or with ``plot`` off (a sweep's milestones
    before its last), the plots are skipped; the checkpoints are always
    written. ``fold_ids`` names the dirs when they are not 0..n_folds-1
    (a bootstrap replicate set may be non-contiguous)."""
    from ..train.checkpoints import save_checkpoint
    from ..utils.logging import Logger, plot_losses

    if plot and importlib.util.find_spec('matplotlib') is None:
        plot = False
        print('matplotlib is not installed: skipping the loss plots '
              '(Losses*.png); checkpoints and the run log are written')

    if fold_ids is None:
        fold_ids = range(n_folds)

    def emit(i):
        fold_dir = model_dir / f'{fold_ids[i]:03d}'
        fold_dir.mkdir(parents=True, exist_ok=True)
        if plot:
            logger = Logger()
            logger.extend(per_fold_logs[i])
            plot_losses(logger, fold_dir, 'training')
        save_checkpoint(fold_dir, per_fold_params[i], model_config)

    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(emit, range(n_folds)))
