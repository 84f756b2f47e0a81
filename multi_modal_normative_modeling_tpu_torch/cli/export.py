"""AOT model export (counterpart of cli/export.py): a trained fold-ensemble
as a self-contained ``torch.export`` scoring program.

The ``.mmnm`` artifact is a zip of ``meta.json`` and serialized
``ExportedProgram``s, per platform a scoring program (``scoring.cpu.pt2``,
``scoring.cuda.pt2``) and, where the variant has a deterministic fused
latent, a latent program (``latent.cpu.pt2``, ...). They hold the scoring
pipeline with the trained state as their parameters and buffers:

  * every fold's parameters, stacked (fold k is checkpoint k);
  * per-fold RobustScaler centres and scales (refit from each fold's train
    ids, the reference's serving convention, test script:82-90);
  * per-fold covariate bins (train-quantile edges or the nearest train
    values, data/preprocess.binned_covariate_graph_spec), applied in the
    graph;
  * per-fold train-cohort latent statistics (latent_deviation z-scoring,
    utils_vae.py:155-161) when the variant has a deterministic fused
    latent.

The scoring program's ``forward(x_0, ..., x_{M-1}, age, gender, eps)``
takes the raw feature matrices [n, F_m], numeric AGE and PTGENDER [n] and
the noise ``eps`` [K, n, Z], and returns (devs [K, M, n], roi [K, n,
sum F_m]); the latent program's ``forward(x_0, ..., x_{M-1}, age,
gender)`` returns (latent_dev [K, n], latent_z [K, n, D]). The JAX package
exports one program with all four outputs; two programs let a request
without latent scores skip the latent's encoder launches, as
cli/serve.py does. The batch ``n`` is symbolic, and the inputs are
row-major (contiguous), as the kernels take them. On the card the encoder
and decode+deviation kernels (K1, K2) run inside the programs as the
custom operators ``mmnm::fused_encoder`` and
``mmnm::fused_pred_deviation`` (kernels/ops.py): a scoring call launches
each once per modality, a latent call K1 once more per modality. The CPU
programs run their plain versions.

The noise is an input, where the JAX program draws it inside itself:
``torch.export`` cannot carry a seeded generator. ``ExportedScorer`` pads a
request to the 64-row bucket and draws fold k's noise from a generator
seeded ``seeds[k]`` over the padded rows (``infer/ensemble.fold_eps``), as
cli/serve.py does, so its answers equal ``ScoringService.score_raw`` on the
same payload and a subject's score does not change with the batch inside
one bucket. Loading a program needs torch and this package's ``kernels``
(which registers the operators), nothing else of the port.

    python -m multi_modal_normative_modeling_tpu_torch.cli.export \
        -R ADNI -P UCA-gPoE -K 10 -o model.mmnm [--platforms cpu,cuda]
    scorer = load_scorer('model.mmnm')            # the card; device='cpu'
    out = scorer.score({'av45': X, ...}, {'AGE': ages, 'PTGENDER': genders})
"""
from __future__ import annotations

import argparse
import copy
import io
import json
import zipfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import kernels  # noqa: F401  (registers mmnm::*)
from ..data.preprocess import binned_covariate_graph_spec, one_hot_codes
from ..infer.ensemble import (
    EnsembleState,
    EpsFn,
    ensure_latent_stats,
    fold_eps,
    latent_zscores,
    load_ensemble,
    scaled,
    score_body,
    validate_features,
)

FORMAT = 'mmnm-torch-export/1'
META_MEMBER = 'meta.json'
COVARIATES = ('AGE', 'PTGENDER')
PLATFORMS = ('cpu', 'cuda')
BUCKET = 64   # padded rows: a multiple of this, as cli/serve.py pads


def program_member(platform: str, kind: str = 'scoring') -> str:
    return f'{kind}.{platform}.pt2'


class ScoringProgram(nn.Module):
    """The whole-ensemble scoring program of an ``EnsembleState`` (or, with
    ``latent``, its latent program); its state is a copy of the ensemble's,
    on the ensemble's device."""

    def __init__(self, state: EnsembleState, latent: bool = False):
        super().__init__()
        self.model = copy.deepcopy(state.model)
        self.latent = latent
        self.combine = state.combine
        self.n_mod = len(state.dataset_names)
        for m, (center, scale) in enumerate(zip(state.centers,
                                                state.scales)):
            self.register_buffer(f'center_{m}', center.clone())
            self.register_buffer(f'scale_{m}', scale.clone())
        # per fold, per covariate: (mode, q); the values are buffers
        self.bins = []
        for k, train_cov in enumerate(state.train_covs):
            spec = binned_covariate_graph_spec(train_cov)
            self.bins.append([(e['mode'], e['q']) for e in spec])
            for j, entry in enumerate(spec):
                self.register_buffer(f'bins_{k}_{j}', torch.as_tensor(
                    np.asarray(entry['values'], np.float32),
                    device=state.device))
        if latent:
            ensure_latent_stats(state)
            self.register_buffer('latent_mean', state.latent_mean.clone())
            self.register_buffer('latent_var', state.latent_var.clone())

    def covariates(self, age: torch.Tensor, gender: torch.Tensor):
        """[K, n, C]: each fold's one-hot covariates by its train cohort."""
        return torch.stack([
            torch.cat([one_hot_codes(mode, getattr(self, f'bins_{k}_{j}'),
                                     new, q)
                       for j, ((mode, q), new)
                       in enumerate(zip(spec, (age, gender)))], dim=1)
            for k, spec in enumerate(self.bins)])

    def forward(self, *inputs):
        xes = inputs[:self.n_mod]
        age, gender = inputs[self.n_mod:self.n_mod + 2]
        centers = [getattr(self, f'center_{m}') for m in range(self.n_mod)]
        scales = [getattr(self, f'scale_{m}') for m in range(self.n_mod)]
        covs = self.covariates(age, gender)
        if self.latent:
            return latent_zscores(
                self.model, self.combine, scaled(centers, scales, xes),
                [covs] * self.n_mod, self.latent_mean, self.latent_var)
        return score_body(self.model, self.combine, centers, scales, covs,
                          inputs[-1], xes)


def example_inputs(state: EnsembleState, rows: int, device,
                   latent: bool = False):
    """Zeros of a program's input shapes at ``rows`` padded rows."""
    xes = [torch.zeros(rows, len(cols), device=device)
           for cols in state.columns]
    vec = torch.zeros(rows, device=device)
    if latent:
        return (*xes, vec, vec.clone())
    eps = torch.zeros(state.n_splits, rows, state.model.noise_dim,
                      device=device)
    return (*xes, vec, vec.clone(), eps)


def export_program(state: EnsembleState, device,
                   latent: bool = False) -> torch.export.ExportedProgram:
    """``torch.export`` of the ensemble's scoring (or latent) program on
    ``device``, traced at one bucket of padded rows with the batch
    symbolic."""
    device = torch.device(device)
    program = ScoringProgram(state, latent).to(device).eval()
    args = example_inputs(state, BUCKET, device, latent)
    n = torch.export.Dim('n', min=1)
    # forward(*inputs): one entry, the varargs, in order; eps [K, n, Z]
    dims = [{0: n}] * len(args)
    if not latent:
        dims[-1] = {1: n}
    dynamic = (tuple(dims),)
    with torch.no_grad():
        return torch.export.export(program, args, dynamic_shapes=dynamic,
                                   strict=False)


def export_artifact(state: EnsembleState, out_path,
                    platforms=PLATFORMS) -> dict:
    """Write one program per platform and the metadata into a `.mmnm`
    zip."""
    kinds = ('scoring', 'latent') if state.supports_latent else ('scoring',)
    programs = {}
    for platform in platforms:
        for kind in kinds:
            buf = io.BytesIO()
            torch.export.save(export_program(state, platform,
                                             kind == 'latent'), buf)
            programs[program_member(platform, kind)] = buf.getvalue()
    z_dim = state.model.noise_dim
    meta = {
        'format': FORMAT,
        'resource': state.resource,
        'procedure': state.procedure,
        'combine': state.combine,
        'n_folds': state.n_splits,
        'seed': state.seed,
        'variant': state.config.get('variant', 'cvae'),
        'modalities': state.dataset_names,
        'feature_dims': [len(c) for c in state.columns],
        'columns': {name: cols for name, cols
                    in zip(state.dataset_names, state.columns)},
        'covariates': list(COVARIATES),
        'platforms': list(platforms),
        'torch_version': torch.__version__,
        'has_latent': state.supports_latent,
        'programs': {p: {kind: program_member(p, kind) for kind in kinds}
                     for p in platforms},
        # the noise input: fold k's [rows, latent_dim] draw of a
        # torch.Generator seeded seeds[k], at the bucket-padded rows
        'seeds': [int(s) for s in state.seeds],
        'latent_dim': z_dim,
        'bucket': BUCKET,
        'inputs': [f'{name}[n, {len(cols)}] float32 raw features'
                   for name, cols in zip(state.dataset_names, state.columns)]
                  + [f'{c}[n] float32' for c in COVARIATES]
                  + [f'eps[n_folds, n, {z_dim}] float32 noise'],
        'outputs': ['deviations[n_folds, n_modalities, n] float32',
                    f'roi_sq_error[n_folds, n, '
                    f'{sum(len(c) for c in state.columns)}] float32']
                   + (['latent_deviation[n_folds, n] float32',
                       f'latent_z[n_folds, n, '
                       f'{state.latent_mean.shape[1]}] float32']
                      if state.supports_latent else []),
    }
    out_path = Path(out_path)
    tmp = out_path.with_name(out_path.name + '.tmp')
    with zipfile.ZipFile(tmp, 'w', zipfile.ZIP_DEFLATED) as z:
        z.writestr(META_MEMBER, json.dumps(meta, indent=1))
        for member, blob in programs.items():
            z.writestr(member, blob)
    tmp.replace(out_path)
    return meta


class ExportedScorer:
    """Score raw payloads with one program of a `.mmnm` artifact.

    ``device`` picks the program: the card by default, ``'cpu'`` for the
    CPU program. ``eps_fn`` replaces the seeded noise draw (tests replay
    the JAX package's draws through it, as cli/serve.py's)."""

    def __init__(self, path, device=None, eps_fn: Optional[EpsFn] = None):
        self.device = torch.device(device if device is not None else 'cuda')
        with zipfile.ZipFile(path) as z:
            self.meta = json.loads(z.read(META_MEMBER))
            if self.meta.get('format') != FORMAT:
                raise ValueError(
                    f'{path}: unsupported artifact format '
                    f'{self.meta.get("format")!r} (want {FORMAT!r})')
            platform = self.device.type
            if platform not in self.meta['programs']:
                raise ValueError(
                    f'{path}: no {platform} program (the artifact holds '
                    f"{sorted(self.meta['programs'])})")
            if platform == 'cuda' and not torch.cuda.is_available():
                raise ValueError('no CUDA device is available (load the '
                                 "artifact with device='cpu')")
            self.programs = {
                kind: torch.export.load(io.BytesIO(z.read(member)))
                for kind, member in self.meta['programs'][platform].items()}
        self._modules = {kind: p.module()
                         for kind, p in self.programs.items()}
        self._eps_fn = eps_fn

    def score(self, features: dict, covariates: dict, roi: bool = False,
              fold: int = None, latent: bool = False) -> dict:
        """serve.py-shaped result dict: fold-ensemble mean deviation per
        subject, per-modality means, optional per-ROI squared errors and
        latent z-scores."""
        meta = self.meta
        if fold is not None and not 0 <= fold < meta['n_folds']:
            raise ValueError(f"fold must be in [0, {meta['n_folds']})")
        if latent and not meta.get('has_latent'):
            raise ValueError(
                'this artifact was exported without latent outputs (model '
                f"variant {meta.get('variant')!r} has no deterministic "
                'fused latent)')
        mats, n = validate_features(features, meta['modalities'],
                                    meta['feature_dims'])
        covs = []
        for name in meta['covariates']:
            try:
                vec = np.asarray(covariates[name], np.float32)
            except (KeyError, TypeError, ValueError) as e:
                raise ValueError(
                    f'covariates must carry numeric equal-length '
                    f"{meta['covariates']} lists: {e}") from None
            if vec.shape != (n,):
                raise ValueError(f'covariate {name}: expected [{n}] values, '
                                 f'got {list(vec.shape)}')
            covs.append(vec)

        padded = -(-n // meta['bucket']) * meta['bucket']
        # row-major: the graph keeps no .contiguous() of a traced input that
        # was contiguous, and the kernels refuse another layout
        inputs = [torch.from_numpy(np.ascontiguousarray(np.pad(
            a, ((0, padded - n),) + ((0, 0),) * (a.ndim - 1)))).to(self.device)
            for a in (*mats, *covs)]
        eps = fold_eps(meta['seeds'], padded, meta['latent_dim'],
                       self.device, self._eps_fn)
        with torch.no_grad():
            out = self._modules['scoring'](*inputs, eps)
            if latent:
                out += self._modules['latent'](*inputs)
        devs, rois, *lat = (t.cpu().numpy() for t in out)
        folds = slice(None) if fold is None else slice(fold, fold + 1)
        per_mod = devs[folds, :, :n].mean(axis=0)          # [M, n]
        result = {
            'deviation': per_mod.mean(axis=0).tolist(),
            'per_modality': {name: per_mod[m].tolist()
                             for m, name in enumerate(meta['modalities'])},
            'n_folds': meta['n_folds'] if fold is None else 1,
        }
        if roi:
            result['roi_columns'] = [f'{c}_{name}'
                                     for name in meta['modalities']
                                     for c in meta['columns'][name]]
            result['roi'] = rois[folds, :n].mean(axis=0).tolist()
        if latent:
            lat_s, lat_z = lat
            result['latent_deviation'] = lat_s[folds, :n].mean(
                axis=0).tolist()
            result['latent_per_dim'] = lat_z[folds, :n].mean(axis=0).tolist()
        return result


def load_scorer(path, device=None,
                eps_fn: Optional[EpsFn] = None) -> ExportedScorer:
    return ExportedScorer(path, device=device, eps_fn=eps_fn)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='Export a trained fold-ensemble as a torch.export '
                    'scoring artifact.')
    parser.add_argument('-R', '--dataset_resourse', type=str, default='ADNI')
    parser.add_argument('-P', '--procedure', type=str, default='UCA-gPoE')
    parser.add_argument('-C', '--combine', type=str, default=None)
    parser.add_argument('-K', '--n_splits', type=int, default=10)
    parser.add_argument('--seed', type=int, default=42)
    parser.add_argument('-o', '--output', required=True,
                        help='artifact path to write (convention: .mmnm)')
    parser.add_argument('--platforms', default='cpu,cuda',
                        help='comma-separated programs to export (cpu, '
                             'cuda); cuda needs the card')
    return parser


def run(argv=None, project_root=None):
    args = build_parser().parse_args(argv)
    platforms = [p.strip() for p in args.platforms.split(',') if p.strip()]
    if not platforms:
        raise SystemExit(f'--platforms {args.platforms!r}: no programs '
                         'given')
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown:
        raise SystemExit(f'--platforms {args.platforms!r}: unknown '
                         f'{unknown} (choose from {list(PLATFORMS)})')
    # the ensemble on the card when a cuda program is asked for, else on
    # the CPU; a cuda program without a card is an error, not a CPU one
    if 'cuda' in platforms and not torch.cuda.is_available():
        raise SystemExit(f'--platforms {args.platforms!r}: no CUDA device is '
                         'available for the cuda program (pass --platforms '
                         'cpu for the CPU program alone)')
    device = 'cuda' if 'cuda' in platforms else 'cpu'
    state = load_ensemble(
        args.dataset_resourse, args.procedure, combine=args.combine,
        n_splits=args.n_splits, project_root=project_root, seed=args.seed,
        device=device)
    meta = export_artifact(state, args.output, platforms=platforms)
    size = Path(args.output).stat().st_size
    print(f"exported {meta['resource']}/{meta['procedure']} "
          f"({meta['n_folds']}-fold {meta['variant']} ensemble, "
          f"{'+'.join(meta['modalities'])}) -> {args.output} "
          f"[{size / 1e6:.2f} MB, platforms {','.join(meta['platforms'])}]")
    return meta


if __name__ == '__main__':
    run()
