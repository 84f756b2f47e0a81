"""The port's resident scoring service (cli/serve.py) against the JAX
package's, on the CPU.

One SM-av45 project (one modality, PoE, 2 folds, the JAX serve tests'
configuration) is trained by the JAX trainer; the JAX ScoringService and
the port's (--device cpu: the kernels' plain versions; eps replayed from
the JAX stream PRNGKey(seed + fold) through ``eps_fn``) score the same
requests. Responses agree key for key within rtol 1e-4 / atol 1e-5; both
HTTP front ends give the same status to the same request, malformed ones
included. The port's service is also held to the port's batch scorer, and
to itself under concurrent requests."""
import argparse
import http.client
import json
import logging
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from multi_modal_normative_modeling_tpu.cli import (
    serve as jax_serve,
    train_supervised,
)
from multi_modal_normative_modeling_tpu.data.synthetic import (
    make_synthetic_resource,
)
from multi_modal_normative_modeling_tpu_torch.cli import (
    score,
    serve,
    train_supervised as port_train,
)
from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
    make_synthetic_resource as port_synthetic,
)
from multi_modal_normative_modeling_tpu_torch.infer import ensemble
from tests.test_torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-5)
TOKEN = "s3cret"
BODY_CAP = 512


def jax_eps(seed, rows, z_dim):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                        (rows, z_dim)))


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_project")
    make_synthetic_resource(root, "ADNI", n_hc=60, n_disease={0: 30},
                            effect=1.2)
    train_supervised.main(argparse.Namespace(
        dataset_resourse="ADNI", hz_para_list=[16, 16, 6],
        procedure="SM-av45", combine="PoE", epochs=10, n_splits=2,
        oversample_percentage=1, model="cVAE_multimodal",
        single_modality=None, base_learning_rate=0.0001,
        max_learning_rate=0.005, training_class="nm",
        lr_schedule="constant", fold_parallel=True, precision="fp32"),
        project_root=root)
    return root


@pytest.fixture(scope="module")
def services(project):
    """(the JAX service, the port's on replayed eps)."""
    return (jax_serve.ScoringService("ADNI", "SM-av45", combine="PoE",
                                     n_splits=2, project_root=project),
            serve.ScoringService("ADNI", "SM-av45", combine="PoE",
                                 n_splits=2, project_root=project,
                                 device="cpu", eps_fn=jax_eps))


@pytest.fixture(scope="module")
def port(services):
    return services[1]


def _raw(service, ids):
    rows = service._frames[0].loc[ids]
    return ({"av45": rows[service.columns[0]].to_numpy(float).tolist()},
            {"AGE": rows["AGE"].tolist(),
             "PTGENDER": rows["PTGENDER"].tolist()})


REQUESTS = {
    "ids": dict(n=7),
    "ids roi": dict(n=7, roi=True),
    "ids fold": dict(n=7, roi=True, fold=1),
    "ids latent": dict(n=7, latent=True),
    "ids latent fold": dict(n=5, latent=True, fold=0, roi=True),
    "raw": dict(n=5, raw=True, roi=True),
    "raw latent": dict(n=5, raw=True, latent=True),
    "64 subjects": dict(n=64, roi=True),
    "65 subjects": dict(n=65, latent=True),
}


@pytest.mark.parametrize("case", list(REQUESTS))
def test_service_matches_jax(services, case):
    spec = dict(REQUESTS[case])
    n, raw = spec.pop("n"), spec.pop("raw", False)
    outs = []
    for service in services:
        ids = list(service._frames[0].index[:n])
        outs.append(service.score_raw(*_raw(service, ids), **spec) if raw
                    else service.score_ids(ids, **spec))
    want, got = outs
    assert set(got) == set(want)
    for key, value in want.items():
        if key == "per_modality":
            assert list(got[key]) == list(value) == ["av45"]
            np.testing.assert_allclose(got[key]["av45"], value["av45"], **TOL)
        elif key in ("participant_id", "roi_columns", "n_folds"):
            assert got[key] == value
        else:
            np.testing.assert_allclose(got[key], value, **TOL)
            assert np.asarray(value).shape[0] == n


def test_service_matches_the_port_score_cli(project, port):
    """The service's one ensemble call reproduces cli/score.py (same
    scalers, covariate binning, noise streams) up to on-device float32
    scaling, requested in score's row order (noise is positional)."""
    y = pd.read_csv(project / "data" / "ADNI" / "y.csv")
    y[["IID"]].to_csv(project / "serve_ids.csv", index=False)
    expected = score.score(argparse.Namespace(
        dataset_resourse="ADNI", procedure="SM-av45", combine="PoE",
        n_splits=2, ids=str(project / "serve_ids.csv"), fold=None,
        output=None, roi_output=None, seed=42, device="cpu"),
        project_root=project, eps_fn=jax_eps)
    out = port.score_ids(list(expected["participant_id"]), roi=True)
    np.testing.assert_allclose(out["deviation"], expected["deviation"],
                               rtol=2e-4)
    assert out["participant_id"] == list(expected["participant_id"])
    assert len(out["roi_columns"]) == 90
    merged = pd.DataFrame({"participant_id": out["participant_id"],
                           "deviation": out["deviation"]}).merge(
        y, left_on="participant_id", right_on="IID")
    assert (merged[merged["DIA"] == 0]["deviation"].mean()
            > merged[merged["DIA"] == 2]["deviation"].mean())


def test_raw_payload_matches_ids_mode(port):
    ids = list(port._frames[0].index[:5])
    by_id = port.score_ids(ids)
    raw = port.score_raw(*_raw(port, ids))
    np.testing.assert_allclose(raw["deviation"], by_id["deviation"],
                               rtol=1e-6)
    one_fold = port.score_ids(ids, fold=1)
    assert one_fold["n_folds"] == 1
    assert not np.allclose(one_fold["deviation"], by_id["deviation"])


@pytest.mark.parametrize("call,match", [
    (lambda s: s.score_ids(["nope"]), "unknown participant"),
    (lambda s: s.score_ids([]), "empty"),
    (lambda s: s.score_raw({"av45": [[1.0, 2.0]]},
                           {"AGE": [70], "PTGENDER": [1]}), "expected"),
    (lambda s: s.score_ids(list(s._frames[0].index[:1]), fold=7), "fold"),
    (lambda s: s.score_raw({"av45": [[0.1] * 90, [0.2] * 89]},
                           {"AGE": [70, 71], "PTGENDER": [1, 2]}),
     "not a numeric"),
    (lambda s: s.score_raw({"av45": [["x"] * 90, ["y"] * 90]},
                           {"AGE": [70, 71], "PTGENDER": [1, 2]}),
     "not a numeric"),
    (lambda s: s.score_raw({"av45": [[0.1] * 90]}, {"AGE": [70]}),
     "covariates must carry"),
    (lambda s: s.score_raw({"av45": [[0.1] * 90]},
                           {"AGE": [70], "PTGENDER": ["X"]}),
     "covariate binning failed")], ids=["unknown", "empty", "width", "fold",
                                        "ragged", "non-numeric", "no gender",
                                        "unbinnable"])
def test_request_validation(port, call, match):
    with pytest.raises(serve.ServeError, match=match):
        call(port)


@pytest.mark.parametrize("flag,config,procedure,want", [
    ("MoE", {"combine": "gPoE"}, "SM-av45", "MoE"),
    (None, {"combine": "gPoE"}, "SM-av45", "gPoE"),
    (None, {}, "SE-MoE", "MoE"),
    (None, {}, "SM-av45", ValueError),
    (None, None, "nodash", ValueError)])
def test_resolve_combine_rules(flag, config, procedure, want):
    """Explicit flag > checkpoint config > validated procedure suffix."""
    if want is ValueError:
        with pytest.raises(ValueError, match="pass the fusion explicitly"):
            ensemble.resolve_combine(flag, config, procedure)
    else:
        assert ensemble.resolve_combine(flag, config, procedure) == want


def test_combine_resolution_prefers_checkpoint_config(project):
    """An SM-* procedure's suffix is a modality: without --combine the
    service takes the fusion the checkpoint was trained with."""
    svc = serve.ScoringService("ADNI", "SM-av45", combine=None, n_splits=2,
                               project_root=project, device="cpu")
    assert svc.combine == "PoE" and svc.health()["combine"] == "PoE"
    out = svc.score_ids(list(svc._frames[0].index[:2]))
    assert np.isfinite(np.asarray(out["deviation"])).all()


def test_concurrent_requests_give_the_sequential_answers(project):
    """Twelve threads, each scoring the same cohort with and without
    latent scoring on a fresh service, the first latent requests racing to
    build the train-cohort statistics: every answer equals the sequential
    one, and no served request is lost from the count."""
    svc = serve.ScoringService("ADNI", "SM-av45", combine="PoE", n_splits=2,
                               project_root=project, device="cpu")
    ids = list(svc._frames[0].index[:9])
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    results, errors = [], []

    def worker(i):
        try:
            for _ in range(3):
                results.append(svc.score_ids(ids, latent=bool(i % 2)))
        except Exception as e:  # reported below
            errors.append(e)

    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors
    assert svc.requests_served == len(results) == 36
    plain, latent = svc.score_ids(ids), svc.score_ids(ids, latent=True)
    for out in results:
        want = latent if "latent_deviation" in out else plain
        assert out == want


# ---- HTTP -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def servers(services):
    """{kind: (JAX server's base URL, port server's)}: 'open' with no
    token, 'token' with a bearer token and a 512-byte body cap."""
    started, urls = [], {}
    for kind, kwargs in (("open", {}), ("token", dict(
            auth_token=TOKEN, max_body_bytes=BODY_CAP))):
        pair = []
        for module, service in zip((jax_serve, serve), services):
            server = module.make_server(service, port=0, **kwargs)
            thread = threading.Thread(target=server.serve_forever,
                                      daemon=True)
            thread.start()
            started.append((server, thread))
            host, port_ = server.server_address[:2]
            pair.append((host, port_))
        urls[kind] = pair
    yield urls
    for server, thread in started:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def _request(address, method, path, body=None, headers=(),
             length=True):
    """(status, parsed JSON body, response headers) of one request."""
    conn = http.client.HTTPConnection(*address, timeout=60)
    conn.putrequest(method, path, skip_accept_encoding=True)
    for k, v in headers:
        conn.putheader(k, v)
    if body is not None and length:
        conn.putheader("Content-Length", str(len(body)))
    conn.endheaders()
    if body is not None and length:
        conn.send(body)
    resp = conn.getresponse()
    out = (resp.status, json.loads(resp.read()), dict(resp.getheaders()))
    conn.close()
    return out


IDS = ["ADNI_S_00000", "ADNI_S_00001", "ADNI_S_00002"]
AUTH = [("Authorization", f"Bearer {TOKEN}")]
JSON = [("Content-Type", "application/json")]


def _body(payload):
    return json.dumps(payload).encode()


# (server kind, method, path, body, headers, send Content-Length, status)
HTTP_CASES = {
    "healthz": ("open", "GET", "/healthz", None, [], True, 200),
    "root": ("open", "GET", "/", None, [], True, 200),
    "GET no route": ("open", "GET", "/nope", None, [], True, 404),
    "POST no route": ("open", "POST", "/nope", b"{}", JSON, True, 404),
    "ids": ("open", "POST", "/score", _body({"ids": IDS}), JSON, True, 200),
    "ids latent roi": ("open", "POST", "/score",
                       _body({"ids": IDS, "latent": True, "roi": True}),
                       JSON, True, 200),
    "raw": ("open", "POST", "/score", _body({
        "features": {"av45": [[0.5] * 90] * 2},
        "covariates": {"AGE": [70.0, 81.5], "PTGENDER": [1, 2]}}),
        JSON, True, 200),
    "ragged features": ("open", "POST", "/score", _body({
        "features": {"av45": [[0.1] * 90, [0.2] * 89]},
        "covariates": {"AGE": [70, 71], "PTGENDER": [1, 2]}}),
        JSON, True, 400),
    "non-numeric features": ("open", "POST", "/score", _body({
        "features": {"av45": [["x"] * 90]},
        "covariates": {"AGE": [70], "PTGENDER": [1]}}), JSON, True, 400),
    "empty body": ("open", "POST", "/score", b"", JSON, True, 400),
    "invalid JSON": ("open", "POST", "/score", b"not json at all {{{",
                     JSON, True, 400),
    "binary garbage": ("open", "POST", "/score", b"\x00\x01\x02", JSON,
                       True, 400),
    "neither ids nor features": ("open", "POST", "/score", _body({}), JSON,
                                 True, 400),
    "empty ids": ("open", "POST", "/score", _body({"ids": []}), JSON, True,
                  400),
    "unknown id": ("open", "POST", "/score", _body({"ids": ["nope"]}), JSON,
                   True, 400),
    "odd ids": ("open", "POST", "/score", _body({"ids": [None, 1.5]}), JSON,
                True, 400),
    "features not a dict": ("open", "POST", "/score",
                            _body({"features": "wrong-type"}), JSON, True,
                            400),
    "wrong width": ("open", "POST", "/score", _body({
        "features": {"av45": [[1.0, 2.0]]},
        "covariates": {"AGE": [70], "PTGENDER": [1]}}), JSON, True, 400),
    "missing gender": ("open", "POST", "/score", _body({
        "features": {"av45": [[0.1] * 90]}, "covariates": {"AGE": [70]}}),
        JSON, True, 400),
    "length skew": ("open", "POST", "/score", _body({
        "features": {"av45": [[0.1] * 90]},
        "covariates": {"AGE": [70, 71], "PTGENDER": [1]}}), JSON, True, 400),
    "fold out of range": ("open", "POST", "/score",
                          _body({"ids": IDS, "fold": 99}), JSON, True, 400),
    "roi junk": ("open", "POST", "/score",
                 _body({"ids": IDS, "roi": {"nested": "junk"}}), JSON, True,
                 200),
    "Content-Length unparseable": ("open", "POST", "/score", None,
                                   JSON + [("Content-Length", "nan?")],
                                   True, 411),
    "Content-Length absent": ("open", "POST", "/score", b"{}", JSON, False,
                              411),
    "no token": ("token", "POST", "/score", _body({"ids": IDS[:2]}), JSON,
                 True, 401),
    "wrong token": ("token", "POST", "/score", _body({"ids": IDS[:2]}),
                    JSON + [("Authorization", "Bearer wrong")], True, 401),
    "non-ASCII token": ("token", "POST", "/score", b"{}",
                        JSON + [("Authorization", "Bearer s\xe9cret")],
                        True, 401),
    "token": ("token", "POST", "/score", _body({"ids": IDS[:2]}),
              JSON + AUTH, True, 200),
    "healthz without token": ("token", "GET", "/healthz", None, [], True,
                              200),
    "over the cap": ("token", "POST", "/score",
                     _body({"ids": IDS[:2], "pad": "x" * 4096}),
                     JSON + AUTH, True, 413),
    "over the cap, no token": ("token", "POST", "/score",
                               _body({"ids": IDS[:2], "pad": "x" * 4096}),
                               JSON, True, 401),
}


@pytest.mark.parametrize("case", list(HTTP_CASES))
def test_http_status_matches_jax(servers, case):
    kind, method, path, body, headers, length, status = HTTP_CASES[case]
    jax_address, port_address = servers[kind]
    want = _request(jax_address, method, path, body, headers, length)
    got = _request(port_address, method, path, body, headers, length)
    assert got[0] == want[0] == status, (got[1], want[1])
    assert set(got[1]) >= set(want[1])
    if status == 401:
        assert got[2].get("WWW-Authenticate") == "Bearer"
    if status == 200 and path == "/score":
        for key in ("deviation", "roi", "latent_deviation"):
            if key in want[1]:
                np.testing.assert_allclose(got[1][key], want[1][key], **TOL)
    # the daemon still answers afterwards
    extra = AUTH if kind == "token" else []
    assert _request(port_address, "POST", "/score", _body({"ids": IDS[:1]}),
                    JSON + extra)[0] == 200


def test_healthz_reports_the_torch_device(servers):
    status, body, _ = _request(servers["open"][1], "GET", "/healthz")
    assert status == 200
    assert body["backend"] == body["device"] == "cpu"
    assert body["modalities"] == ["av45"] and body["n_folds"] == 2
    assert body["latent_scoring"] is True and body["mesh"] is None
    assert body["requests_served"] >= 0


def test_make_server_refuses_empty_token_and_warns_on_open_bind(port,
                                                                caplog):
    with pytest.raises(ValueError, match="non-empty"):
        serve.make_server(port, port=0, auth_token="")
    with caplog.at_level(logging.WARNING, logger="mmnm.serve"):
        server = serve.make_server(port, host="0.0.0.0", port=0)
        server.server_close()
    assert any("WITHOUT --auth_token" in r.getMessage()
               for r in caplog.records)


# ---- the CLI --------------------------------------------------------------------------

@pytest.mark.parametrize("argv,match", [
    (["--mesh", "2,1"], "queue 1 item 'Multi-device'"),
    (["--ep_mesh", "1,1,1"], "queue 1 item 'Multi-device'"),
    (["--device", "cuda"], "no CUDA device")], ids=["mesh", "ep_mesh",
                                                    "no card"])
def test_serve_refusals(project, monkeypatch, argv, match):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match=match):
        serve.run(["-R", "ADNI", "-P", "SM-av45", "-K", "2"] + argv,
                  project_root=project)


def test_serve_cli_process(project, tmp_path):
    """``python -m ...cli.serve`` in its own process: the ready file, the
    token from MMNM_SERVE_TOKEN, a scored request; stopped at the end."""
    ready = tmp_path / "ready"
    env = dict(os.environ, MMNM_SERVE_TOKEN=TOKEN,
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "multi_modal_normative_modeling_tpu_torch.cli"
         ".serve", "-R", "ADNI", "-P", "SM-av45", "-K", "2", "--port", "0",
         "--device", "cpu", "--ready_file", str(ready)],
        cwd=project, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 120
        while not ready.exists() and proc.poll() is None \
                and time.time() < deadline:
            time.sleep(0.1)
        assert ready.exists(), proc.stdout.read().decode()
        host, port_ = ready.read_text().strip().rsplit(":", 1)
        address = (host, int(port_))
        assert _request(address, "GET", "/healthz")[0] == 200
        assert _request(address, "POST", "/score", _body({"ids": IDS}),
                        JSON)[0] == 401
        status, body, _ = _request(address, "POST", "/score",
                                   _body({"ids": IDS}), JSON + AUTH)
        assert status == 200 and len(body["deviation"]) == 3
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()


# ---- a model with no latent --------------------------------------------------------

def test_dmvae_serves_no_latent(tmp_path):
    """The DMVAE family (no deterministic fused latent, no kernel) scores
    through pred_recon, advertises latent_scoring false and refuses latent
    requests: ServeError, 400 over HTTP, and score --latent exits."""
    port_synthetic(tmp_path, "ADNI", n_hc=30, n_disease={0: 10})
    port_train.run(["-R", "ADNI", "-P", "SM-av45", "-C", "PoE", "-E", "2",
                    "-K", "2", "-H", "16", "16", "6", "-Model", "DMVAE",
                    "--device", "cpu"], project_root=tmp_path)
    svc = serve.ScoringService("ADNI", "SM-av45", n_splits=2,
                               project_root=tmp_path, device="cpu")
    assert svc.health()["latent_scoring"] is False
    ids = list(svc._frames[0].index[:3])
    out = svc.score_ids(ids, roi=True)
    assert len(out["deviation"]) == 3 and len(out["roi"][0]) == 90
    with pytest.raises(serve.ServeError, match="latent"):
        svc.score_ids(ids, latent=True)
    server = serve.make_server(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        status, body, _ = _request(server.server_address[:2], "POST",
                                   "/score",
                                   _body({"ids": ids, "latent": True}), JSON)
        assert status == 400 and "latent" in body["error"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    pd.DataFrame({"IID": ids}).to_csv(tmp_path / "ids.csv", index=False)
    with pytest.raises(SystemExit, match="no deterministic fused latent"):
        score.score(argparse.Namespace(
            dataset_resourse="ADNI", procedure="SM-av45", combine=None,
            n_splits=2, ids=str(tmp_path / "ids.csv"), fold=None,
            output=None, roi_output=None, seed=42, latent=True,
            device="cpu"), project_root=tmp_path)
