"""Flags and per-fold data prep for the port's CLIs: the jax-free subset of
the JAX package's cli/common.py (add_common_flags,
apply_post_parse_defaults, prepare_modality, prepare_fold_modalities,
prepare_folds, fuse_preps, fold_paths,
assert_modalities_aligned, require_test_cov, infer_row_tile,
check_infer_fold_axis, uniform_covariates, model_config_dict,
build_model_from_config, load_model_and_params, emit_fold_artifacts,
add_resume_flags, require_checkpoint_for_resume, and the --mesh parsers
parse_axis_sizes, parse_mesh, parse_infer_mesh, parse_sweep_mesh,
parse_run_mesh and add_mesh_flag over the port's mesh of ranks) and its
native read path (``read_csv`` through native/fastcsv,
``fast_path_reasons``), without its process-wide memo caches, plus the
k-fold id files without sklearn.

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
from ..data.loading import (  # noqa: F401  (the CLIs' fold-id writers)
    fast_inner_merge,
    generate_kfold_ids,
    generate_kfold_ids_endtoend,
    kfold_split,
    load_demographic_data,
)
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


def add_variant_flags(parser: argparse.ArgumentParser,
                      ep_mesh: bool = False) -> None:
    """--device, --fold_parallel (which --mesh requires), --mesh,
    --checkpoint_every/--resume, --packed_xla, and with ``ep_mesh`` the
    JAX end-to-end CLI's --ep_mesh F,M,D."""
    parser.add_argument('--device', dest='device', default='cuda',
                        help='torch device to run on (default cuda); cuda '
                             'runs the kernels, cpu their plain versions')
    parser.add_argument('--fold_parallel', dest='fold_parallel',
                        action='store_true',
                        help='the port always trains every fold at once; '
                             'required by --mesh, as in the JAX CLIs')
    parser.add_argument('--packed_xla', dest='packed_xla',
                        action='store_true',
                        help='train on the packed-modality layout (every '
                             'layer one batched product over the '
                             'modalities); where the configuration does not '
                             'take it, says why and trains the per-modality '
                             'layout.')
    if ep_mesh:
        add_ep_mesh_flag(parser, '2,2,2')
    # after --ep_mesh, where the JAX CLIs have it (results_endtoend.csv
    # prints the flags in this order)
    add_mesh_flag(parser)
    add_resume_flags(parser)


def refuse_not_ported(args, what: str, flags: Dict[str, str]) -> None:
    """Exit, citing why, on any of ``flags`` set ({flag: the ROADMAP.md
    entry that keeps it unported})."""
    for flag, item in flags.items():
        if getattr(args, flag, None):
            raise SystemExit(f'--{flag} is not ported to the torch {what} '
                             f'yet; see ROADMAP.md, {item}')


@contextlib.contextmanager
def profiled(args):
    """``--profile_dir DIR``: the run inside a torch.profiler trace written
    under DIR (utils.profiling.trace; JAX cli/train_supervised.py:766-770,
    cli/pipeline.py:77-81); nothing without the flag."""
    log_dir = getattr(args, 'profile_dir', None)
    if not log_dir:
        yield
        return
    from ..utils.profiling import trace

    with trace(log_dir):
        yield
    print(f'profile: {trace.last}')


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
                 device, row_slice: Optional[slice] = None) -> torch.Tensor:
    """[len(arrays), rows, width] float32 on ``device``: each array's rows
    first, zero rows after (rows are independent through every model).
    With ``row_slice`` only those rows (a rank's part on a mesh), made
    contiguous, as the kernels take them."""
    out = np.zeros((len(arrays), rows, arrays[0].shape[1]), np.float32)
    for i, a in enumerate(arrays):
        out[i, :a.shape[0]] = a
    if row_slice is not None:
        out = np.ascontiguousarray(out[:, row_slice])
    return torch.from_numpy(out).to(device)


def padded_rows(n: int, mesh=None) -> int:
    """``n`` rows padded to the scoring call's bucket (infer_row_tile)."""
    tile = infer_row_tile(mesh)
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


def infer_row_tile(mesh=None, base: int = 64) -> int:
    """Row-padding bucket of the scoring call (cli/common.py:664-671 of the
    JAX package): every fold is padded to the same multiple of it, so the
    padded rows, and with them the eps draw of each fold, match the JAX
    stage; with a mesh the bucket also divides evenly over 'data'."""
    if mesh is None:
        return base
    import math

    return math.lcm(base, mesh.shape['data'])


def check_infer_fold_axis(mesh, n_folds: int, what: str = 'folds') -> None:
    """Exit when the folds to score do not divide over the 'fold' axis."""
    if mesh is None:
        return
    ax = mesh.shape['fold']
    if n_folds % ax:
        raise SystemExit(f"--mesh: {n_folds} {what} not divisible by the "
                         f"fold axis ({ax})")


def _world() -> int:
    from ..parallel import distributed

    return distributed.world_size()


def parse_axis_sizes(spec, flag: str, n_axes, usage: str):
    """Comma- (or 'x'-) separated mesh axis sizes -> list[int], validated
    against positivity, the allowed axis counts and the run's ranks, the
    port's devices (cli/common.py:530-551 of the JAX package, its
    messages). SystemExit with the flag's usage on any error."""
    try:
        sizes = [int(s) for s in str(spec).replace('x', ',').split(',')]
    except ValueError:
        raise SystemExit(f"{flag} {spec!r}: expected comma-separated axis "
                         f"sizes, e.g. {usage}")
    if len(sizes) not in n_axes:
        counts = ' or '.join(str(n) for n in sorted(n_axes))
        raise SystemExit(f"{flag} takes {counts} axis sizes: {usage}")
    if any(s < 1 for s in sizes):
        raise SystemExit(f"{flag} {spec}: axis sizes must be positive")
    total = int(np.prod(sizes))
    if total != _world():
        raise SystemExit(f"{flag} {spec}: {total} mesh slots != "
                         f"{_world()} visible devices")
    return sizes


def ep_mesh_divisibility(sizes, n_folds: int, batch_size: int,
                         modalities: int, modality_axis_len=None,
                         modality_axis_desc=None):
    """Why an --ep_mesh geometry (M,D or F,M,D axis sizes) cannot launch,
    or None (cli/common.py:579-609 of the JAX package, its messages): the
    fold axis must divide the folds, the 'modality' axis the modalities
    (``modality_axis_len``/``modality_axis_desc`` for a layout whose split
    axis is not [M]: the dual-bank end-to-end trainer's [2M]), and in the
    M,D form the 'data' axis the batch."""
    if len(sizes) == 3:
        if n_folds % sizes[0]:
            return (f"{n_folds} folds not divisible by the fold axis "
                    f"({sizes[0]})")
        m_axis, d_axis = sizes[1], sizes[2]
    else:
        m_axis, d_axis = sizes
    mal = modalities if modality_axis_len is None else modality_axis_len
    desc = (f"{modalities} modalities" if modality_axis_desc is None
            else f"{modality_axis_desc}={mal}")
    if mal % m_axis:
        return (f"{desc} not divisible over the "
                f"{m_axis}-way 'modality' mesh axis")
    if len(sizes) == 2 and batch_size % d_axis:
        return (f"batch_size {batch_size} not divisible over the "
                f"{d_axis}-way 'data' mesh axis")
    return None


def parse_ep_mesh(spec, forms, usage: str, device='cpu'):
    """--ep_mesh 'M,D' or 'F,M,D' (the axis counts ``forms``) -> (the
    ('modality', 'data') or ('fold', 'modality', 'data') Mesh, its sizes),
    joining the run's process group; None without a spec."""
    if not spec:
        return None, None
    from ..parallel.modality import make_ep_mesh, make_ep_mesh3

    sizes = parse_axis_sizes(spec, '--ep_mesh', forms, usage)
    try:
        if len(sizes) == 3:
            return make_ep_mesh3(*sizes, device=device), sizes
        return make_ep_mesh(*sizes, device=device), sizes
    except ValueError as exc:
        raise SystemExit(f'--ep_mesh {spec}: {exc}')


def add_ep_mesh_flag(parser: argparse.ArgumentParser, example: str) -> None:
    parser.add_argument('--ep_mesh', dest='ep_mesh', default=None,
                        metavar='[F,]M,D',
                        help='expert-parallel: shard the packed modality '
                             'axis over a mesh of ranks (one process each, '
                             'started by python -m torch.distributed.run), '
                             f'e.g. {example}; F,M,D = fold x modality x '
                             'data on the packed layouts, M,D the 2-axis '
                             'expert-parallel trainer (train CLI); the '
                             'product must equal the number of ranks.')


def parse_mesh(spec, n_folds: int, batch_size: int, device='cpu'):
    """--mesh 'F,D' or 'F,D,M' -> (Mesh, shardings_fn or None), joining
    the run's process group (cli/common.py:554-576 of the JAX package).
    Validates against the run's ranks and the divisibility rules the plans
    rely on (folds over F, batch rows over D). Three axes engage the
    tensor-parallel plan (parallel/tensor.py)."""
    if not spec:
        return None, None
    sizes = parse_axis_sizes(spec, '--mesh', (2, 3),
                             '2,4 or 2,2,2 (fold,data[,model])')
    if n_folds % sizes[0]:
        raise SystemExit(f"--mesh {spec}: {n_folds} folds not divisible by "
                         f"the fold axis ({sizes[0]})")
    n_data = sizes[1]
    if n_data > 1 and batch_size % n_data:
        raise SystemExit(f"--mesh {spec}: batch size {batch_size} not "
                         f"divisible by the data axis ({n_data})")
    from ..parallel import fold_model_shardings, make_mesh, make_mesh3

    if len(sizes) == 2:
        return make_mesh(n_fold=sizes[0], n_data=sizes[1],
                         device=device), None
    return (make_mesh3(n_fold=sizes[0], n_data=sizes[1], n_model=sizes[2],
                       device=device), fold_model_shardings)


def parse_infer_mesh(spec, device='cpu'):
    """--mesh 'F,D' (or the train stage's 'F,D,M': one flag set drives the
    whole chain) -> a ('fold', 'data') Mesh for the scoring calls: folds
    over 'fold', padded rows over 'data' (cli/common.py:612-640 of the JAX
    package). A 'model' axis has no role in row-independent inference, so
    it folds into 'data'. Fold-count divisibility is checked where the
    folds with checkpoints are known."""
    if not spec:
        return None
    try:
        sizes = [int(s) for s in str(spec).replace('x', ',').split(',')]
    except ValueError:
        sizes = []
    if any(s < 1 for s in sizes):
        raise SystemExit(f"--mesh {spec}: axis sizes must be positive")
    if len(sizes) == 3:
        sizes = [sizes[0], sizes[1] * sizes[2]]
    if len(sizes) != 2:
        raise SystemExit(f"--mesh {spec!r}: expected two comma-separated "
                         "axis sizes, e.g. 2,4 (fold,data)")
    if sizes[0] * sizes[1] != _world():
        raise SystemExit(f"--mesh {spec}: {sizes[0] * sizes[1]} mesh slots "
                         f"!= {_world()} visible devices")
    from ..parallel import make_mesh

    return make_mesh(n_fold=sizes[0], n_data=sizes[1], device=device)


def parse_sweep_mesh(spec, n_configs: int, n_folds: int, device='cpu'):
    """--mesh 'S,F' -> a ('config', 'fold') Mesh for the sweep engine
    (cli/common.py:684-711 of the JAX package)."""
    if not spec:
        return None
    try:
        sizes = [int(s) for s in str(spec).replace('x', ',').split(',')]
    except ValueError:
        sizes = []
    if len(sizes) != 2:
        raise SystemExit(f"--mesh {spec!r}: expected two comma-separated "
                         "axis sizes, e.g. 4,2 (config,fold)")
    if any(s < 1 for s in sizes):
        raise SystemExit(f"--mesh {spec}: axis sizes must be positive")
    total = sizes[0] * sizes[1]
    if total != _world():
        raise SystemExit(f"--mesh {spec}: {total} mesh slots != "
                         f"{_world()} visible devices")
    if n_configs % sizes[0]:
        raise SystemExit(f"--mesh {spec}: {n_configs} grid configs not "
                         f"divisible by the config axis ({sizes[0]})")
    if n_folds % sizes[1]:
        raise SystemExit(f"--mesh {spec}: {n_folds} folds not divisible by "
                         f"the fold axis ({sizes[1]})")
    from ..parallel.mesh import make_sweep_mesh

    return make_sweep_mesh(n_config=sizes[0], n_fold=sizes[1], device=device)


def parse_run_mesh(args, n_folds: int, batch_size: int, device='cpu'):
    """A CLI's --mesh as (Mesh, shardings_fn) for the fold-parallel trainer
    (cli/common.py:714-731 of the JAX package): --fold_parallel is required
    (the port's flag is otherwise a no-op, the JAX contract is kept); the
    mesh geometry is announced when one engages."""
    spec = getattr(args, 'mesh', None)
    if spec and not getattr(args, 'fold_parallel', False):
        raise SystemExit('--mesh requires --fold_parallel (the mesh shards '
                         'the fold-parallel program)')
    mesh, shardings_fn = parse_mesh(spec, n_folds=n_folds,
                                    batch_size=batch_size, device=device)
    if mesh is not None:
        announce_mesh(mesh, 'fold-parallel training')
    return mesh, shardings_fn


def primary(mesh) -> bool:
    """Whether this process writes files: rank 0 of a mesh, or the one
    process without one."""
    return mesh is None or mesh.primary


def barrier(mesh) -> None:
    if mesh is not None:
        mesh.barrier()


def mesh_parts(mesh, n_folds: int, rows: int):
    """The (fold, row) slices of a [F, rows, ...] scoring operand this
    rank computes (all of it without a mesh)."""
    from ..parallel.mesh import infer_shards

    if mesh is None:
        return slice(None), slice(None)
    return infer_shards(mesh, n_folds, rows)


def gather_parts(mesh, arrays, n_folds: int):
    """Every rank's [F/nf, rows/nd, ...] parts put together (the arrays
    themselves without a mesh)."""
    from ..parallel.mesh import gather_fold_rows

    return list(arrays) if mesh is None else gather_fold_rows(
        mesh, list(arrays), n_folds)


def announce_mesh(mesh, what: str) -> None:
    """Rank 0 prints the mesh's geometry and its backend."""
    if mesh.primary:
        print(f'{what} over a {mesh.shape} device mesh ({mesh.size} ranks, '
              f'{mesh.backend or "no"} process group, {mesh.device})',
              flush=True)


def add_mesh_flag(parser: argparse.ArgumentParser) -> None:
    """The --mesh flag of every fold-parallel-capable trainer CLI."""
    parser.add_argument('--mesh', dest='mesh', default=None, metavar='F,D',
                        help='shard the fold-parallel program over a mesh of '
                             'ranks (one process each, started by python -m '
                             'torch.distributed.run): F,D (folds x data-'
                             'parallel) or F,D,M (+ tensor-parallel model '
                             'axis); the product must equal the number of '
                             'ranks; requires --fold_parallel')


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


def packed_layout(model, config, folds, mesh=None) -> Optional[tuple]:
    """``--packed_xla``'s layout for ``model`` (select_packed_trainer's
    (trainer class, layout name, tag)), or None, printing why, where the
    JAX package's run_folds(packed=True) trains the per-modality layout
    (cli/common.py:833-853): a mesh, packed_supported's reason, or
    non-uniform covariates."""
    from ..train.grouped import select_packed_trainer
    from ..train.packed import packed_supported

    ok, reason = packed_supported(model, config)
    if mesh is not None:
        ok, reason = False, '--mesh'
    if ok:
        reason = uniform_covariates(folds)
    if reason:
        print(f'--packed_xla unavailable ({reason}); '
              'using the per-modality layout')
        return None
    return select_packed_trainer(model)


def packed_state_dir(root: Path, tag: str, resumable: Resumable) -> Path:
    """A packed layout's whole-run train-state dir under ``root``, named as
    the JAX package names its layout's (``packed_state_dirname``); on a
    resume, the note on a mixed-width cohort's leftover padded state."""
    from ..train.grouped import (
        notice_stale_padded_state,
        packed_state_dirname,
    )

    if resumable.every and resumable.resume:
        notice_stale_padded_state(root, tag)
    return Path(root) / packed_state_dirname(tag)


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
