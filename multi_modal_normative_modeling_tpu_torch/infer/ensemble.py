"""Fold-ensemble scoring core (counterpart of infer/ensemble.py), shared by
the batch scorer (cli/score.py) and the scoring service (cli/serve.py).

Both score NEW subjects against a trained k-fold ensemble with the
reference's serving convention (multimodal_kfold_test_cvae_supervised.py:
82-90): each fold's RobustScaler is refit from that fold's train ids, each
fold conditions on covariates binned by ITS train cohort
(data/preprocess.train_binned_covariates), each fold draws its own noise,
and the ensemble score is the fold mean. This module owns the per-fold
state restore (checkpoints, scaler center/scale, train covariate cohorts)
and the per-fold scale -> encode -> fuse -> decode -> deviate body.

The JAX package vmaps a one-fold body over fold-stacked params; here the
fold axis is written out: one fold-stacked model on the device scores
every fold in one call. For a model of the cVAE skeleton (cVAE_multimodal,
mmJSD, mvtCAE) that call is, on CUDA, one encoder kernel launch (K1) and
one decode+deviation kernel launch (K2) per modality, each covering every
fold, and the latent body one K1 launch per modality; on the CPU the same
code runs the kernels' plain versions. The DMVAE family has no kernel in
either package: it goes through ``pred_recon`` and has no latent.

Not ported: the expert-parallel and width-grouped serving layouts
(``pack_ensemble_ep``, ``fold_infer_fn_ep``, ``pack_ensemble_grouped``,
``fold_infer_fn_grouped``), ROADMAP queue 1 items 'Multi-device' and
'Grouped layout'.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import registry
from ..cli import common

# (seed, rows, z_dim) -> a [rows, z_dim] noise draw; common.seeded_eps by
# default, the JAX package's normal(PRNGKey(seed), [rows, Z]) in the tests
EpsFn = Callable[[int, int, int], np.ndarray]


@dataclass
class EnsembleState:
    """Everything needed to score new subjects with a trained ensemble.
    The tensors live on the model's device."""

    resource: str
    procedure: str
    combine: str
    n_splits: int
    seed: int
    model: torch.nn.Module   # fold-stacked: fold k is checkpoint k
    config: dict             # cVAE_model.json, the same for every fold
    dataset_names: List[str]
    columns: List[List[str]]  # per-modality feature column names
    centers: Tuple[torch.Tensor, ...]  # per modality [K, F_m] scaler centers
    scales: Tuple[torch.Tensor, ...]   # per modality [K, F_m] scaler scales
    seeds: np.ndarray        # [K] per-fold noise seeds
    train_covs: list         # per fold: AGE/PTGENDER frame of the train ids
    project_root: Optional[Path] = None  # for lazy train-cohort re-reads
    # per-fold train-cohort fused-latent statistics ([K, D] each), feeding
    # latent_deviation / separate_latent_deviation (utils_vae.py:155-161)
    # for NEW subjects; computed on first need by ensure_latent_stats (a
    # whole-train-cohort encode that recon-only deployments never need)
    latent_mean: Optional[torch.Tensor] = None
    latent_var: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def supports_latent(self) -> bool:
        """Whether the variant has a deterministic fused latent (the DMVAE
        family splits private/shared latents and exposes none)."""
        return hasattr(self.model, 'latent_stats_fused')


def validate_features(features: dict, modalities, feature_dims,
                      error_cls=ValueError):
    """Raw-payload feature validation for the scoring front-ends
    (serve.score_raw): per-modality presence + shape, cross-modality
    subject-count agreement. Returns (mats, n_subjects)."""
    mats = []
    for name, dim in zip(modalities, feature_dims):
        if name not in features:
            raise error_cls(f'missing features for modality {name!r} '
                            f'(need {list(modalities)})')
        try:
            mat = np.asarray(features[name], np.float32)
        except (ValueError, TypeError) as exc:
            # ragged rows / non-numeric cells: keep the error_cls contract
            # (serve maps it to a 400) instead of leaking a raw ValueError
            raise error_cls(f'modality {name!r}: features are not a '
                            f'numeric [n_subjects, {dim}] matrix ({exc})')
        if mat.ndim != 2 or mat.shape[1] != dim:
            raise error_cls(
                f'modality {name!r}: expected [n_subjects, {dim}] '
                f'features, got {list(mat.shape)}')
        mats.append(mat)
    ns = {m.shape[0] for m in mats}
    if len(ns) != 1:
        raise error_cls(f'modalities disagree on subject count: {ns}')
    return mats, ns.pop()


def resolve_combine(combine, config, procedure: str) -> str:
    """Fusion method for a scoring surface: explicit flag > the fusion the
    checkpoint was trained with (config['combine'], written by
    common.model_config_dict on every trainer) > the reference's
    '<datasets>-<fusion>' procedure-suffix convention (train:293). The
    suffix is a MODALITY name for SM-* procedures, so when the heuristic
    must be used it is validated here: a bad guess would otherwise surface
    as ValueError('No such combination method') at the first scoring
    request (or silently score through the M == 1 single-modality
    shortcut)."""
    if combine:
        return combine
    from_config = (config or {}).get('combine')
    if from_config:
        return from_config
    parts = str(procedure).split('-')
    guess = parts[1] if len(parts) > 1 else ''
    if guess.lower() not in ('poe', 'gpoe', 'moe', 'mopoe'):
        raise ValueError(
            'cannot infer the fusion method: the checkpoint config records '
            f"no 'combine' and procedure {procedure!r} has suffix "
            f"{guess!r}, not one of ('poe', 'gpoe', 'moe', 'mopoe') — pass "
            'the fusion explicitly (--combine)')
    return guess


def train_preps(project_root: Path, resource: str, dataset_names,
                n_splits: int) -> list:
    """prepare_modality of every (fold, modality) on the fold's train ids:
    one list of preps per fold, in modality order."""
    kfold_dir = project_root / 'outputs' / 'kfold_analysis'
    return common.prepare_fold_modalities(
        project_root, resource, dataset_names,
        project_root / 'data' / resource / 'y.csv',
        [(common.fold_paths(kfold_dir, fold)[0], None)
         for fold in range(n_splits)])


def load_ensemble(resource: str, procedure: str, combine: str = None,
                  n_splits: int = 10, project_root=None, seed: int = 42,
                  device='cuda') -> EnsembleState:
    """Restore every fold's checkpoint + train-cohort preprocessing state
    from a trained experiment directory (outputs/kfold_analysis), the
    fold-stacked model on ``device`` (the card unless the caller asks for
    the CPU; a missing card is an error, common.resolve_device)."""
    device = common.resolve_device(str(device), 'load the ensemble')
    project_root = Path(project_root) if project_root else Path.cwd()
    model_dir = project_root / 'outputs' / 'kfold_analysis' / 'supervised_cvae'
    dataset_names = registry.get_datasets_name(resource, procedure)

    centers, scales, train_covs = [], [], []
    for fold, preps in enumerate(train_preps(project_root, resource,
                                              dataset_names, n_splits)):
        # the per-fold covariates (and latent stats) pair modality-0 row
        # order with the last modality's frame: only coherent when every
        # modality CSV covers the same subjects in the same order
        common.assert_modalities_aligned(
            [p['train_df'] for p in preps],
            f'{resource}/{procedure} fold {fold} train cohort')
        centers.append([np.asarray(p['scaler'].center, np.float32)
                        for p in preps])
        scales.append([np.asarray(p['scaler'].scale, np.float32)
                       for p in preps])
        # covariates ride the demographic merge, identical across modalities
        train_covs.append(preps[-1]['train_df'][['AGE', 'PTGENDER']])
    model, _, config = common.load_model_and_params(
        [model_dir / f'{fold:03d}' for fold in range(n_splits)], device)
    model.eval()

    def per_modality(blocks):
        return tuple(torch.from_numpy(np.stack([b[m] for b in blocks]))
                     .to(device) for m in range(len(dataset_names)))

    return EnsembleState(
        resource=resource,
        procedure=procedure,
        combine=resolve_combine(combine, config, procedure),
        n_splits=n_splits,
        seed=seed,
        model=model,
        config=config,
        dataset_names=list(dataset_names),
        columns=[registry.get_column_name(resource, n)
                 for n in dataset_names],
        centers=per_modality(centers),
        scales=per_modality(scales),
        seeds=np.arange(n_splits) + seed,
        train_covs=train_covs,
        project_root=project_root,
    )


def ensure_latent_stats(state: EnsembleState,
                        device_lock=contextlib.nullcontext()) -> None:
    """Fill state.latent_mean/latent_var on first need (idempotent).

    Deferred out of load_ensemble so recon-only serving startups skip the
    whole-train-cohort encode; the per-fold train matrices are re-derived
    from the tables. The device work runs under ``device_lock`` (the
    service's lock: the kernels' scratch assumes ordered calls)."""
    if not state.supports_latent:
        raise ValueError(
            f"model variant {state.config.get('variant', 'cvae')!r} has no "
            'deterministic fused latent; latent deviation scoring is '
            'unavailable')
    if state.latent_mean is not None:
        return
    fold_preps = train_preps(state.project_root, state.resource,
                              state.dataset_names, state.n_splits)
    with device_lock:
        state.latent_mean, state.latent_var = train_latent_stats(
            state.model, state.combine, fold_preps)


@torch.no_grad()
def train_latent_stats(model, combine: str, fold_preps):
    """Per-fold mean/var ([K, D]) of the fused latent posterior means over
    each fold's (oversampled) train cohort, the ``mu_train`` statistics of
    latent_deviation (utils_vae.py:155-157), as ONE fold-stacked call
    (ragged folds padded + masked; the masked moments match np.mean /
    np.var ddof=0 on the unpadded rows). ``fold_preps`` holds one list of
    prepare_modality results per fold, in modality order."""
    n_mod = len(fold_preps[0])
    sizes = [len(preps[-1]['train_cov']) for preps in fold_preps]
    n_max = max(sizes)
    device = next(model.parameters()).device
    xs = [common.stack_padded([preps[m]['train_data'] for preps in fold_preps],
                              n_max, device) for m in range(n_mod)]
    covs = common.stack_padded([preps[-1]['train_cov'] for preps in fold_preps],
                               n_max, device)
    mask = torch.from_numpy(np.stack(
        [np.arange(n_max) < s for s in sizes]).astype(np.float32)).to(device)
    mu, _ = model.latent_stats_fused(xs, [covs] * n_mod, combine)
    w = mask[:, :, None]
    denom = torch.sum(mask, dim=1)[:, None]
    mean = torch.sum(mu * w, dim=1) / denom
    var = torch.sum(w * (mu - mean[:, None]) ** 2, dim=1) / denom
    return mean, var


def fold_eps(seeds: Sequence[int], rows: int, z_dim: int, device,
             eps_fn: Optional[EpsFn] = None) -> torch.Tensor:
    """[K, rows, z_dim] on ``device``: fold k's noise is one [rows, z_dim]
    draw seeded ``seeds[k]``, so the same padded size gets the same noise
    and a subject's score depends on its row in the padded batch (as in
    the JAX package, whose draw is normal(PRNGKey(seed), [rows, Z]); the
    streams differ, tests replay the JAX draws through ``eps_fn``)."""
    eps_fn = eps_fn or common.seeded_eps
    return torch.from_numpy(np.stack([
        np.asarray(eps_fn(int(s), rows, z_dim), np.float32).reshape(
            rows, z_dim) for s in seeds])).to(device)


def reconstruct(model, xs, cs, combine: str, eps: torch.Tensor):
    """The stochastic reconstruction of every fold in one call (reference
    quirk Q2: pred_recon samples z). xs and cs per modality [K, n, .].
    Returns (recons per modality [K, n, F_m], devs [K, M, n]); through K1
    and K2 for the cVAE skeleton, ``pred_recon`` for the DMVAE family."""
    if hasattr(model, 'pred_recon_fused'):
        recons, devs = model.pred_recon_fused(xs, cs, combine, eps=eps)
    else:
        with torch.no_grad():
            recons = model.pred_recon(xs, cs, combine, eps=eps)
        devs = [model.reconstruction_deviation(x, r)
                for x, r in zip(xs, recons)]
    return recons, torch.stack(devs, dim=1)


def scaled(centers, scales, xes):
    """Raw features per modality [n, F_m], broadcast over the folds and
    scaled by each fold's train scaler (``centers``, ``scales`` per
    modality [K, F_m]): [K, n, F_m], contiguous as the kernels take them
    (the result of a broadcast keeps the layout of its operand, which may
    be column-major: a numpy matrix taken from a frame)."""
    return [((x - c[:, None]) / s[:, None]).contiguous()
            for x, c, s in zip(xes, centers, scales)]


def score_body(model, combine: str, centers, scales, covs: torch.Tensor,
               eps: torch.Tensor, xes) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fold_infer`` on its operands alone (the exported scoring program,
    cli/export.py, traces it): (devs [K, M, n], roi [K, n, sum F_m])."""
    xs = scaled(centers, scales, xes)
    recons, devs = reconstruct(model, xs, [covs] * len(xs), combine, eps)
    roi = torch.cat([(x - r) ** 2 for x, r in zip(xs, recons)], dim=2)
    return devs, roi


@torch.no_grad()
def fold_infer(state: EnsembleState, covs: torch.Tensor, eps: torch.Tensor,
               xes) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scoring body of every fold (the JAX package's fold_infer_fn,
    vmapped): scale the raw features ``xes`` (per modality [n, F_m]) by
    each fold's train scaler, reconstruct with the fold's eps ([K, n, Z])
    and covariates ([K, n, C]), the per-modality scalar deviations and the
    concatenated per-ROI squared-error plane, all on the device in
    float32. Returns (devs [K, M, n], roi [K, n, sum F_m])."""
    return score_body(state.model, state.combine, state.centers,
                      state.scales, covs, eps, xes)


@torch.no_grad()
def fold_latent(state: EnsembleState, covs: torch.Tensor,
                xes) -> Tuple[torch.Tensor, torch.Tensor]:
    """The latent deviation body of every fold (fold_latent_fn, vmapped):
    scale, deterministic fused-latent posterior (no sampling), then
    z-score against the fold's train-cohort latent statistics. Returns
    (scalar [K, n], per_dim [K, n, D]), matching latent_deviation /
    separate_latent_deviation (utils_vae.py:155-161)."""
    return latent_zscores(state.model, state.combine,
                          scaled(state.centers, state.scales, xes),
                          [covs] * len(xes), state.latent_mean,
                          state.latent_var)


@torch.no_grad()
def latent_zscores(model, combine: str, xs, cs, train_mean: torch.Tensor,
                   train_var: torch.Tensor) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """The deterministic fused-latent posterior of the scaled ``xs`` (per
    modality [K, n, F_m]) z-scored against each fold's train statistics
    ([K, D]). Returns (scalar [K, n] = sum |z| / D, z [K, n, D])."""
    mu, var = model.latent_stats_fused(xs, cs, combine)
    z = (mu - train_mean[:, None]) / torch.sqrt(train_var[:, None] + var)
    return torch.sum(torch.abs(z), dim=2) / mu.shape[2], z
