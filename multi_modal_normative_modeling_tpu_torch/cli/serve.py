"""Resident normative-model scoring service (counterpart of cli/serve.py).

The reference's only scoring path is the k-fold test script re-run from
scratch, which pays the process start, the CUDA start and the model and
data load on every request. This daemon pays them once:

  * at startup it loads every fold checkpoint into one fold-stacked model
    on the device, refits each fold's RobustScaler from its train ids (the
    reference's serving convention, test script:82-90) and keeps each
    fold's train covariate cohort, by which it bins a request's covariates
    (data/preprocess.train_binned_covariates);
  * a request is one scoring call covering every fold on the device
    (infer/ensemble.fold_infer): on CUDA one K1 (encoder) and one K2
    (decode+deviation) launch per modality, and a latent request one more
    K1 launch per modality; a launch that fails answers 500, it never
    falls back to the plain versions;
  * requests are served over HTTP (stdlib, loopback by default):
      GET  /healthz            liveness + model/config introspection
      POST /score              {"ids": [...]} resolved against the
                               project's modality tables, or raw payloads
                               {"features": {modality: [[...], ...]},
                                "covariates": {"AGE": [...],
                                               "PTGENDER": [...]}}
                               (+ optional "roi": true, "fold": int,
                                "latent": true for latent z-scores against
                                each fold's train-cohort latent statistics,
                                utils_vae.py:155-161)
  * batch sizes are padded to a bucket multiple (64 rows), which keeps the
    kernels' per-shape state and the noise draws to a few shapes.

Fold f's noise is one [padded rows, Z] draw seeded ``seed`` + f, drawn
anew for each padded size: the same size gets the same noise, and a
subject's score depends on its row in the padded batch, as in the JAX
package and in cli/score.py.

Threads: ThreadingHTTPServer answers each request on its own thread. Host
work (JSON, table lookup, covariate binning) runs concurrently; all device
work, the device-to-host copies included, runs under the service lock,
because the kernels' scratch is one tensor per shape and assumes calls
ordered on one stream. The first latent request computes the train-cohort
statistics under a second lock, their device part under the service lock.

Bind contract (non-loopback hardening):

  * default bind is loopback (127.0.0.1), safe on a shared box with no
    further configuration;
  * binding any other interface is allowed but should carry a bearer token
    (``--auth_token`` or the ``MMNM_SERVE_TOKEN`` env var). With a token
    set, every ``POST /score`` must send ``Authorization: Bearer <token>``
    (constant-time comparison) or gets 401; ``GET /healthz`` stays open for
    liveness probes and carries no cohort data. A non-loopback bind with
    no token logs a loud warning;
  * request bodies are capped (``--max_body_bytes``, default 64 MiB, sized
    for a batch-256 PPMI-width raw JSON payload): oversized or length-less
    requests are rejected 413/411 BEFORE the body is read, so a hostile
    client cannot balloon daemon memory;
  * TLS is out of scope: front with a reverse proxy for encrypted or
    internet-facing deployments.

Not ported: the --mesh and --ep_mesh programs (ROADMAP queue 1 item
'Multi-device'); both flags exit.

    python -m multi_modal_normative_modeling_tpu_torch.cli.serve \
        -R ADNI -P UCA-gPoE -K 5 [--device cpu] [--ready_file FILE]
"""
from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

import numpy as np
import pandas as pd
import torch

from ..data.preprocess import train_binned_covariates
from ..infer.ensemble import (
    EpsFn,
    ensure_latent_stats,
    fold_eps,
    fold_infer,
    fold_latent,
    load_ensemble,
    validate_features,
)
from . import common

_NOT_PORTED_FLAGS = {'mesh': "queue 1 item 'Multi-device'",
                     'ep_mesh': "queue 1 item 'Multi-device'"}


class ServeError(ValueError):
    """Client-visible request error (HTTP 400)."""


class ScoringService:
    """Fold-ensemble deviation scoring with all state resident in memory.

    One instance per trained experiment directory; thread-safe (device
    work is serialized on a lock, host prep runs concurrently).
    """

    def __init__(self, resource: str, procedure: str, combine: str = None,
                 n_splits: int = 10, project_root=None, seed: int = 42,
                 pad_to: int = 64, device='cuda',
                 eps_fn: Optional[EpsFn] = None):
        self.device = common.resolve_device(str(device), 'serve')
        self.resource = resource
        self.procedure = procedure
        self.n_splits = n_splits
        self.seed = seed
        self.pad_to = pad_to
        self.project_root = Path(project_root) if project_root else Path.cwd()
        self.started = time.time()
        self.requests_served = 0
        self._lock = threading.Lock()
        # separate build lock: concurrent FIRST latent requests must not
        # race ensure_latent_stats' state mutation, and holding the device
        # lock through the tables' re-read would stall plain scoring
        self._latent_build_lock = threading.Lock()
        self._eps_fn = eps_fn

        kfold_dir = self.project_root / 'outputs' / 'kfold_analysis'
        participants_path = self.project_root / 'data' / resource / 'y.csv'

        # ---- per-fold state: model, scalers, train covariate cohorts ----
        # the trained config's 'combine' beats the procedure-suffix
        # heuristic (wrong for SM-*): infer.ensemble.resolve_combine
        self.state = load_ensemble(resource, procedure, combine=combine,
                                   n_splits=n_splits,
                                   project_root=self.project_root, seed=seed,
                                   device=self.device)
        self.combine = self.state.combine
        self.dataset_names = self.state.dataset_names
        self.config = self.state.config
        self._train_covs = self.state.train_covs

        # ---- full-cohort modality frames for ids-mode resolution ----
        self.columns = self.state.columns
        self._frames = []
        all_ids = kfold_dir / 'serve_all_ids.csv'
        all_ids.parent.mkdir(parents=True, exist_ok=True)
        pd.DataFrame({'IID': pd.read_csv(participants_path)['IID']}).to_csv(
            all_ids, index=False)
        for name in self.dataset_names:
            frame = common.load_dataset(
                participants_path, all_ids,
                self.project_root / 'data' / resource / f'{name}.csv')
            frame = frame.set_index('participant_id')
            if not frame.index.is_unique:
                raise ValueError(f'{resource}/{name}: participant ids repeat '
                                 'in the modality table')
            self._frames.append(frame)
        # a request's rows are taken from these by position: pandas'
        # row and column selection on the frames costs milliseconds a
        # request, a numpy take microseconds, for the same values
        self._features = [frame[cols].to_numpy(np.float32)
                          for frame, cols in zip(self._frames, self.columns)]
        self._covariates = self._frames[-1][['AGE', 'PTGENDER']]

    def _ensure_latent(self) -> None:
        with self._latent_build_lock:
            try:
                ensure_latent_stats(self.state, device_lock=self._lock)
            except ValueError as e:
                raise ServeError(str(e))

    # ------------------------------------------------------------- scoring
    def score_ids(self, ids, roi: bool = False, fold: int = None,
                  latent: bool = False) -> dict:
        """Score subjects already present in the project's modality tables."""
        if not ids:
            raise ServeError('empty ids list')
        rows = []
        for name, frame in zip(self.dataset_names, self._frames):
            at = frame.index.get_indexer(list(ids))
            missing = [i for i, row in zip(ids, at) if row < 0]
            if missing:
                raise ServeError(
                    f'unknown participant id(s) in modality {name}: '
                    f'{missing[:5]}')
            rows.append(at)
        features = [mat[at] for mat, at in zip(self._features, rows)]
        covariates = self._covariates.iloc[rows[-1]]  # last-modality
        result = self._score(features, covariates, roi=roi, fold=fold,
                             latent=latent)
        result['participant_id'] = list(ids)
        return result

    def score_raw(self, features: dict, covariates: dict, roi: bool = False,
                  fold: int = None, latent: bool = False) -> dict:
        """Score raw feature payloads (no project-table lookup)."""
        mats, n = validate_features(features, self.dataset_names,
                                    [len(c) for c in self.columns],
                                    error_cls=ServeError)
        try:
            cov_frame = pd.DataFrame({'AGE': covariates['AGE'],
                                      'PTGENDER': covariates['PTGENDER']})
        except (KeyError, TypeError, ValueError) as e:
            raise ServeError(f'covariates must carry equal-length AGE and '
                             f'PTGENDER lists: {e}')
        if len(cov_frame) != n:
            raise ServeError('covariate length != subject count')
        return self._score(mats, cov_frame, roi=roi, fold=fold,
                           latent=latent)

    def _score(self, features, cov_frame, roi: bool, fold,
               latent: bool = False) -> dict:
        if fold is not None and not 0 <= fold < self.n_splits:
            raise ServeError(f'fold must be in [0, {self.n_splits})')
        if latent:
            self._ensure_latent()
        n = features[0].shape[0]
        padded = -(-n // self.pad_to) * self.pad_to
        xes = [np.pad(f, ((0, padded - n), (0, 0))) for f in features]
        try:
            covs = np.stack([
                train_binned_covariates(tc, cov_frame).astype(np.float32)
                for tc in self._train_covs])               # [K, n, C]
        except ValueError as e:
            raise ServeError(f'covariate binning failed: {e}')
        covs = np.pad(covs, ((0, 0), (0, padded - n), (0, 0)))
        # torch.no_grad is thread-local: entered on the serving thread
        with self._lock, torch.no_grad():
            xes = [torch.from_numpy(x).to(self.device) for x in xes]
            covs = torch.from_numpy(covs).to(self.device)
            eps = fold_eps(self.state.seeds, padded,
                           self.state.model.noise_dim, self.device,
                           self._eps_fn)
            devs, rois = fold_infer(self.state, covs, eps, xes)
            devs = devs[:, :, :n].cpu().numpy()            # [K, M, n]
            rois = rois[:, :n].cpu().numpy() if roi else None
            if latent:
                lat_s, lat_z = fold_latent(self.state, covs, xes)
                lat_s = lat_s[:, :n].cpu().numpy()         # [K, n]
                lat_z = lat_z[:, :n].cpu().numpy()         # [K, n, D]
            self.requests_served += 1
        folds = slice(None) if fold is None else slice(fold, fold + 1)
        per_mod = devs[folds].mean(axis=0)                 # [M, n]
        out = {
            'deviation': per_mod.mean(axis=0).tolist(),
            'per_modality': {name: per_mod[m].tolist()
                             for m, name in enumerate(self.dataset_names)},
            'n_folds': self.n_splits if fold is None else 1,
        }
        if roi:
            out['roi_columns'] = [f'{c}_{name}' for cols, name
                                  in zip(self.columns, self.dataset_names)
                                  for c in cols]
            out['roi'] = rois[folds].mean(axis=0).tolist()
        if latent:
            out['latent_deviation'] = lat_s[folds].mean(axis=0).tolist()
            out['latent_per_dim'] = lat_z[folds].mean(axis=0).tolist()
        return out

    def health(self) -> dict:
        return {
            'status': 'ok',
            'resource': self.resource,
            'procedure': self.procedure,
            'combine': self.combine,
            'n_folds': self.n_splits,
            'modalities': list(self.dataset_names),
            'feature_dims': [len(c) for c in self.columns],
            'model': self.config.get('variant', 'cvae'),
            'latent_scoring': self.state.supports_latent,
            # the JAX service's mesh programs are not ported
            'mesh': None,
            'ep_layout': None,
            'backend': self.device.type,
            'device': (torch.cuda.get_device_name(self.device)
                       if self.device.type == 'cuda' else 'cpu'),
            'uptime_seconds': round(time.time() - self.started, 1),
            'requests_served': self.requests_served,
        }


# ------------------------------------------------------------------ HTTP
DEFAULT_MAX_BODY_BYTES = 64 * 1024 * 1024  # fits a batch-256 PPMI-width
#                                            (3 x 3485 floats) raw JSON body


def make_server(service: ScoringService, host: str = '127.0.0.1',
                port: int = 0, auth_token: str = None,
                max_body_bytes: int = DEFAULT_MAX_BODY_BYTES,
                ) -> ThreadingHTTPServer:
    """Build the HTTP server around a :class:`ScoringService`.

    ``auth_token`` (optional) gates every POST behind
    ``Authorization: Bearer <token>`` (compared constant-time);
    ``GET /healthz`` stays open for liveness probes. ``max_body_bytes``
    rejects oversized (413) or length-less (411) requests before the body
    is read. See the module docstring's bind contract.
    """
    import hmac
    import logging

    if auth_token is not None and not auth_token:
        raise ValueError('auth_token must be non-empty when set')
    if host not in ('127.0.0.1', 'localhost', '::1') and not auth_token:
        logging.getLogger('mmnm.serve').warning(
            'binding non-loopback interface %s WITHOUT --auth_token: '
            'any client that can reach this port can score payloads — '
            'set --auth_token / MMNM_SERVE_TOKEN (module docstring: '
            'bind contract)', host)

    class Handler(BaseHTTPRequestHandler):
        server_version = 'mmnm-serve/1.0'

        def log_message(self, fmt, *args):  # route through logging, not
            logging.getLogger('mmnm.serve').info(fmt, *args)  # stderr

        def _reply(self, code: int, payload: dict, headers=()):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _authorized(self) -> bool:
            if auth_token is None:
                return True
            # compare as bytes: compare_digest raises TypeError on
            # non-ASCII str operands (headers decode as latin-1), which
            # would abort the connection instead of returning 401
            supplied = self.headers.get('Authorization', '').encode(
                'latin-1', 'backslashreplace')
            expected = f'Bearer {auth_token}'.encode(
                'latin-1', 'backslashreplace')
            return hmac.compare_digest(supplied, expected)

        def do_GET(self):
            if self.path.rstrip('/') in ('', '/healthz'):
                self._reply(200, service.health())
            else:
                self._reply(404, {'error': f'no route {self.path}'})

        def do_POST(self):
            if self.path.rstrip('/') != '/score':
                self._reply(404, {'error': f'no route {self.path}'})
                return
            if not self._authorized():
                self._reply(401, {'error': 'missing or invalid bearer '
                                           'token'},
                            headers=[('WWW-Authenticate', 'Bearer')])
                return
            # a MISSING header must also 411 (the contract: reject
            # length-less requests before reading; a chunked body left
            # unread would desync subsequent keep-alive requests)
            raw_length = self.headers.get('Content-Length')
            try:
                length = int(raw_length)
            except (TypeError, ValueError):
                length = -1
            if length < 0:
                self._reply(411, {'error': 'Content-Length required'})
                return
            if length > max_body_bytes:
                # refuse BEFORE reading: the cap exists so a hostile
                # client cannot balloon daemon memory
                self._reply(413, {'error': f'request body {length} bytes '
                                  f'exceeds cap {max_body_bytes}'})
                return
            try:
                req = json.loads(self.rfile.read(length) or b'{}')
                roi = bool(req.get('roi', False))
                fold = req.get('fold')
                latent = bool(req.get('latent', False))
                if 'ids' in req:
                    out = service.score_ids(req['ids'], roi=roi, fold=fold,
                                            latent=latent)
                elif 'features' in req:
                    out = service.score_raw(req['features'],
                                            req.get('covariates', {}),
                                            roi=roi, fold=fold,
                                            latent=latent)
                else:
                    raise ServeError(
                        "request needs 'ids' or 'features'+'covariates'")
                self._reply(200, out)
            except (ServeError, json.JSONDecodeError) as e:
                self._reply(400, {'error': str(e)})
            except Exception as e:  # keep the daemon alive on surprises
                logging.getLogger('mmnm.serve').exception('request failed')
                self._reply(500, {'error': f'{type(e).__name__}: {e}'})

    return ThreadingHTTPServer((host, port), Handler)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='Serve a trained normative model over HTTP.')
    parser.add_argument('-R', '--dataset_resourse', type=str, default='ADNI')
    parser.add_argument('-P', '--procedure', type=str, default='UCA-gPoE')
    parser.add_argument('-C', '--combine', type=str, default=None)
    parser.add_argument('-K', '--n_splits', type=int, default=10)
    parser.add_argument('--host', default='127.0.0.1')
    parser.add_argument('--port', type=int, default=8465)
    parser.add_argument('--seed', type=int, default=42)
    parser.add_argument('--ready_file', default=None,
                        help='write host:port here once listening (for '
                             'scripts/tests that need the bound port).')
    parser.add_argument('--device', default='cuda',
                        help='torch device to serve on (default cuda); cuda '
                             'runs the kernels, cpu their plain versions')
    parser.add_argument('--mesh', dest='mesh', default=None, metavar='F,D',
                        help='not ported yet (raises); see ROADMAP.md')
    parser.add_argument('--ep_mesh', dest='ep_mesh', default=None,
                        metavar='F,M,D',
                        help='not ported yet (raises); see ROADMAP.md')
    parser.add_argument('--auth_token', default=None,
                        help='require "Authorization: Bearer <token>" on '
                             'POST /score (default: $MMNM_SERVE_TOKEN if '
                             'set; /healthz stays open for liveness). '
                             'Strongly recommended for non-loopback binds '
                             '— see the module docstring bind contract.')
    parser.add_argument('--max_body_bytes', type=int,
                        default=DEFAULT_MAX_BODY_BYTES,
                        help='reject request bodies larger than this '
                             '(413) before reading them (default 64 MiB)')
    return parser


def run(argv=None, project_root=None):
    import os

    args = build_parser().parse_args(argv)
    common.refuse_not_ported(args, 'scoring service', _NOT_PORTED_FLAGS)
    token = args.auth_token or os.environ.get('MMNM_SERVE_TOKEN') or None
    service = ScoringService(
        args.dataset_resourse, args.procedure, combine=args.combine,
        n_splits=args.n_splits, project_root=project_root, seed=args.seed,
        device=args.device)
    server = make_server(service, args.host, args.port, auth_token=token,
                         max_body_bytes=args.max_body_bytes)
    host, port = server.server_address[:2]
    if args.ready_file:
        Path(args.ready_file).write_text(f'{host}:{port}\n')
    print(f'serving {args.dataset_resourse}/{args.procedure} '
          f'({args.n_splits}-fold ensemble) on http://{host}:{port} '
          f'— POST /score, GET /healthz', flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()
    return server


if __name__ == '__main__':
    run()
