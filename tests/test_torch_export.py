"""AOT model export (cli/export.py) of the port against the JAX package's,
on the CPU.

The in-graph covariate binning is held to the host path and to the JAX
package's in-graph binning (tests/test_export.py:28-80). One UCA-gPoE
project (four modalities, 2 folds) is trained by the JAX trainer; the
port exports its CPU program (the card's program needs the card:
tests/test_torch_cuda.py and chip_smoke.py phase 14b) and its scorer is
held to the port's ScoringService on the same payload (the same bucket
padding and per-fold noise) at rtol 1e-6, and to the JAX exported scorer
on JAX's draws replayed through ``eps_fn`` at rtol 1e-5 on deviations and
rtol 1e-4 / atol 1e-6 on the ROI plane and the latent z-scores. The
program holds K1 and K2 as ``mmnm::*`` custom-op nodes, runs at any padded
batch, and loads in a process that imports torch and the port's
``kernels`` alone.
"""
import argparse
import json
import subprocess
import sys
import zipfile
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from multi_modal_normative_modeling_tpu.cli import (
    export as jax_export,
    train_supervised,
)
from multi_modal_normative_modeling_tpu.data import preprocess as jax_prep
from multi_modal_normative_modeling_tpu.data.synthetic import (
    make_synthetic_resource,
)
from multi_modal_normative_modeling_tpu_torch.cli import export, serve
from multi_modal_normative_modeling_tpu_torch.data import preprocess
from multi_modal_normative_modeling_tpu_torch.kernels import deviation, mlp
from tests.test_torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SERVE_TOL = dict(rtol=1e-6, atol=0.0)
DEV_TOL = dict(rtol=1e-5, atol=0.0)
ROI_TOL = dict(rtol=1e-4, atol=1e-6)
MODALITIES = ["av45", "vbm", "fdg", "early_fusion_modalities_ADNI"]


def jax_eps(seed, rows, z_dim):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                        (rows, z_dim)))


# --------------------------------------------------------- in-graph binning
def _cov(age, gender):
    return pd.DataFrame({"AGE": age, "PTGENDER": gender})


def _apply(spec, age, gender):
    return preprocess.apply_binned_covariate_spec(
        spec, torch.from_numpy(np.asarray(age, np.float32)),
        torch.from_numpy(np.asarray(gender, np.float32))).numpy()


@pytest.mark.parametrize("n_train", [12, 200])
def test_graph_binning_matches_host_path_and_jax(n_train):
    """Both branches: the nearest train value (<= q distinct values: always
    PTGENDER; AGE with 12 train subjects) and the quantile edges (AGE
    when 200 draws exceed 27 uniques)."""
    rng = np.random.RandomState(3)
    train = _cov(rng.uniform(55, 95, n_train).round(1),
                 rng.choice([1, 2], n_train))
    new = _cov(rng.uniform(50, 99, 37).round(1), rng.choice([1, 2], 37))
    spec = preprocess.binned_covariate_graph_spec(train)
    jspec = jax_prep.binned_covariate_graph_spec(train)
    for e, je in zip(spec, jspec):
        assert (e["mode"], e["q"], e["col"]) == (je["mode"], je["q"],
                                                  je["col"])
        np.testing.assert_array_equal(e["values"], je["values"])
    modes = {e["col"]: e["mode"] for e in spec}
    assert modes["PTGENDER"] == "nearest"
    assert modes["AGE"] == ("nearest" if n_train == 12 else "quantile")
    age = new["AGE"].to_numpy(np.float32)
    gender = new["PTGENDER"].to_numpy(np.float32)
    got = _apply(spec, age, gender)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(
        got, preprocess.train_binned_covariates(train, new))
    np.testing.assert_array_equal(got, np.asarray(
        jax_prep.apply_binned_covariate_spec(jspec, age, gender)))


def test_nearest_ties_take_the_first_index():
    """A value halfway between two train values takes the lower one, as
    jnp.argmin does."""
    train = _cov([60.0, 62.0, 64.0], [1, 2, 1])
    spec = preprocess.binned_covariate_graph_spec(train)
    age = np.array([61.0, 63.0, 59.0, 65.0], np.float32)
    gender = np.array([1.5, 1.0, 2.0, 1.5], np.float32)
    np.testing.assert_array_equal(
        _apply(spec, age, gender),
        np.asarray(jax_prep.apply_binned_covariate_spec(
            jax_prep.binned_covariate_graph_spec(train), age, gender)))


def test_quantile_edges_exact_for_float32_inputs():
    """float32 neighbours straddling every rounded-up edge bin as the
    float64 host path does."""
    rng = np.random.RandomState(7)
    train = _cov(rng.uniform(55.0, 95.0, 500), rng.choice([1, 2], 500))
    spec = preprocess.binned_covariate_graph_spec(train)
    age_entry = next(e for e in spec if e["col"] == "AGE")
    assert age_entry["mode"] == "quantile"
    edges64 = np.quantile(np.asarray(train["AGE"], np.float64),
                          np.linspace(0.0, 1.0, 28)[1:-1])
    assert (np.float32(edges64) != edges64).any()
    hi = np.asarray(age_entry["values"], np.float32)
    lo = np.nextafter(hi, np.float32(-np.inf))
    probes = np.concatenate([hi, lo])
    gender = np.ones(len(probes), np.float32)
    np.testing.assert_array_equal(
        _apply(spec, probes, gender),
        preprocess.train_binned_covariates(train, _cov(probes, gender)))


def test_categorical_covariates_not_exportable():
    train = _cov([60, 61, 62], ["Male", "Female", "Male"])
    with pytest.raises(ValueError, match="categorical"):
        preprocess.binned_covariate_graph_spec(train)


# ----------------------------------------------------------- the operators
def _layers(rng, folds, sizes):
    out = []
    for k, n in zip(sizes, sizes[1:]):
        out += [torch.from_numpy(rng.normal(size=(folds, n, k))
                                 .astype(np.float32) * 0.3),
                torch.from_numpy(rng.normal(size=(folds, n))
                                 .astype(np.float32) * 0.1)]
    return out


@pytest.mark.parametrize("op", ["fused_encoder", "fused_pred_deviation",
                                "fused_decoder_mean"])
def test_custom_op_registration(op):
    """torch.library.opcheck: the schema, the fake implementation's shapes
    against the CPU implementation, and dispatch under a symbolic trace;
    the CPU implementation is the plain version."""
    rng = np.random.default_rng(0)
    folds, rows, d, c, z = 2, 5, 9, 3, 4
    x = torch.from_numpy(rng.normal(size=(folds, rows, d)).astype(np.float32))
    cov = torch.from_numpy(rng.normal(size=(folds, rows, c))
                           .astype(np.float32))
    zz = torch.from_numpy(rng.normal(size=(folds, rows, z))
                          .astype(np.float32))
    if op == "fused_encoder":
        hidden = _layers(rng, folds, [d + c, 7, 6])
        heads = _layers(rng, folds, [6, z]) + _layers(rng, folds, [6, z])
        args = (x, cov, hidden + heads, 2, True, None)
        want = mlp.encoder_reference(
            [tuple(hidden[:2]), tuple(hidden[2:])], tuple(heads[:2]),
            tuple(heads[2:]), x, cov, True)
    else:
        layers = _layers(rng, folds, [z + c, 6, 7, d])
        pairs = [tuple(layers[i:i + 2]) for i in range(0, len(layers), 2)]
        if op == "fused_pred_deviation":
            args = (zz, cov, x, layers, True)
            want = deviation.pred_deviation_reference(pairs[:-1], pairs[-1],
                                                      zz, cov, x, True)
        else:
            args = (zz, cov, layers, True)
            want = (deviation.decode_mean_reference(pairs[:-1], pairs[-1],
                                                    zz, cov, True),)
    packet = getattr(torch.ops.mmnm, op)
    result = torch.library.opcheck(packet.default, args)
    assert set(result.values()) == {"SUCCESS"}, result
    got = packet(*args)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ------------------------------------------------------------ the artifact
@pytest.fixture(scope="module")
def project(tmp_path_factory):
    root = tmp_path_factory.mktemp("export_project")
    make_synthetic_resource(root, "ADNI", n_hc=60, n_disease={0: 30},
                            effect=1.2, with_early_fusion=True)
    train_supervised.main(argparse.Namespace(
        dataset_resourse="ADNI", hz_para_list=[16, 16, 6],
        procedure="UCA-gPoE", combine="gPoE", epochs=5, n_splits=2,
        oversample_percentage=1, model="cVAE_multimodal",
        single_modality=None, base_learning_rate=0.0001,
        max_learning_rate=0.005, training_class="nm",
        lr_schedule="constant", fold_parallel=True, precision="fp32"),
        project_root=root)
    return root


FLAGS = ["-R", "ADNI", "-P", "UCA-gPoE", "-K", "2"]


@pytest.fixture(scope="module")
def artifact(project, tmp_path_factory):
    out = tmp_path_factory.mktemp("artifact") / "model.mmnm"
    meta = export.run(FLAGS + ["-o", str(out), "--platforms", "cpu"],
                      project_root=project)
    return out, meta


@pytest.fixture(scope="module")
def jax_artifact(project, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_artifact") / "model.mmnm"
    jax_export.run(FLAGS + ["-o", str(out), "--platforms", "cpu"],
                   project_root=project)
    return out


@pytest.fixture(scope="module")
def service(project):
    return serve.ScoringService("ADNI", "UCA-gPoE", n_splits=2,
                                project_root=project, device="cpu")


@pytest.fixture(scope="module")
def scorer(artifact):
    return export.load_scorer(artifact[0], device="cpu")


def _payload(service, ids):
    rows = [f.loc[ids] for f in service._frames]
    features = {name: r[cols].to_numpy(np.float32) for name, r, cols
                in zip(service.dataset_names, rows, service.columns)}
    covariates = {"AGE": rows[-1]["AGE"].tolist(),
                  "PTGENDER": rows[-1]["PTGENDER"].tolist()}
    return features, covariates


def _close(got, want, keys, tol):
    for key in keys:
        if key == "per_modality":
            for name in want[key]:
                np.testing.assert_allclose(got[key][name], want[key][name],
                                           **tol, err_msg=name)
        else:
            np.testing.assert_allclose(got[key], want[key], **tol,
                                       err_msg=key)


def test_artifact_meta(artifact, jax_artifact):
    path, meta = artifact
    with zipfile.ZipFile(jax_artifact) as z:
        jax_meta = json.loads(z.read("meta.json"))
    assert set(jax_meta) - {"jax_version"} <= set(meta)
    assert meta["format"] == export.FORMAT
    assert meta["modalities"] == MODALITIES
    assert meta["feature_dims"] == jax_meta["feature_dims"]
    assert meta["columns"] == jax_meta["columns"]
    assert meta["n_folds"] == 2 and meta["seeds"] == [42, 43]
    assert meta["platforms"] == ["cpu"]
    assert meta["programs"] == {"cpu": {"scoring": "scoring.cpu.pt2",
                                        "latent": "latent.cpu.pt2"}}
    assert meta["covariates"] == ["AGE", "PTGENDER"]
    assert meta["has_latent"] is True and len(meta["outputs"]) == 4
    assert meta["outputs"] == jax_meta["outputs"]
    assert meta["inputs"][:-1] == jax_meta["inputs"]
    assert meta["torch_version"] == torch.__version__
    assert (meta["bucket"], meta["latent_dim"]) == (64, 6)
    with zipfile.ZipFile(path) as z:
        assert sorted(z.namelist()) == ["latent.cpu.pt2", "meta.json",
                                        "scoring.cpu.pt2"]


def test_programs_hold_the_custom_ops(scorer):
    """The scoring program K1 and K2 per modality, the latent program K1
    per modality: opaque mmnm nodes in the exported graphs."""
    m = len(MODALITIES)
    for kind, want in (("scoring", (m, m)), ("latent", (m, 0))):
        targets = [str(n.target) for n in scorer.programs[kind].graph.nodes
                   if n.op == "call_function"]
        assert (targets.count("mmnm.fused_encoder.default"),
                targets.count("mmnm.fused_pred_deviation.default")) == want
        assert "mmnm.fused_decoder_mean.default" not in targets


@pytest.mark.parametrize("n", [1, 9, 64, 70, 200])
def test_exported_scoring_matches_serve(scorer, service, n):
    """Padded to 64, 128 and 256 rows: the program's symbolic batch."""
    features, covariates = _payload(service, list(service._frames[0].index[:n]))
    want = service.score_raw(features, covariates, roi=True, latent=True)
    got = scorer.score(features, covariates, roi=True, latent=True)
    assert got["roi_columns"] == want["roi_columns"]
    assert got["n_folds"] == want["n_folds"] == 2
    _close(got, want, ["deviation", "per_modality", "roi",
                       "latent_deviation", "latent_per_dim"], SERVE_TOL)


@pytest.mark.parametrize("fold", [0, 1])
def test_exported_fold_matches_serve(scorer, service, fold):
    features, covariates = _payload(service, list(service._frames[0].index[:7]))
    want = service.score_raw(features, covariates, roi=True, fold=fold)
    got = scorer.score(features, covariates, roi=True, fold=fold)
    assert got["n_folds"] == 1
    _close(got, want, ["deviation", "per_modality", "roi"], SERVE_TOL)


def test_port_scorer_matches_jax_scorer(artifact, jax_artifact, service):
    """On the JAX-trained checkpoints, with JAX's draws replayed."""
    port = export.load_scorer(artifact[0], device="cpu", eps_fn=jax_eps)
    ref = jax_export.load_scorer(jax_artifact)
    for n in (9, 64):
        features, covariates = _payload(service,
                                        list(service._frames[0].index[:n]))
        got = port.score(features, covariates, roi=True, latent=True)
        want = ref.score(features, covariates, roi=True, latent=True)
        assert got["roi_columns"] == want["roi_columns"]
        _close(got, want, ["deviation", "per_modality"], DEV_TOL)
        _close(got, want, ["roi", "latent_deviation", "latent_per_dim"],
               ROI_TOL)


def test_batch_dimension_is_polymorphic(scorer, service):
    """A subject's score does not change with the batch inside one
    bucket."""
    features, covariates = _payload(service,
                                    list(service._frames[0].index[:11]))
    full = scorer.score(features, covariates)
    head = scorer.score({k: v[:3] for k, v in features.items()},
                        {k: v[:3] for k, v in covariates.items()})
    assert len(full["deviation"]) == 11 and len(head["deviation"]) == 3
    np.testing.assert_allclose(head["deviation"], full["deviation"][:3],
                               rtol=1e-6)


def test_loader_validation(scorer):
    ok_cov = {"AGE": [70.0], "PTGENDER": [1.0]}
    feats = {name: np.zeros((1, d), np.float32) for name, d
             in zip(scorer.meta["modalities"], scorer.meta["feature_dims"])}
    with pytest.raises(ValueError, match="expected \\[n_subjects, 90\\]"):
        scorer.score(dict(feats, av45=[[1.0, 2.0]]), ok_cov)
    with pytest.raises(ValueError, match="missing features"):
        scorer.score({"wrong": np.zeros((1, 90))}, ok_cov)
    with pytest.raises(ValueError, match="covariate PTGENDER"):
        scorer.score({k: np.zeros((2, v.shape[1]), np.float32)
                      for k, v in feats.items()},
                     {"AGE": [70.0, 71.0], "PTGENDER": [1.0]})
    with pytest.raises(ValueError, match="fold"):
        scorer.score(feats, ok_cov, fold=5)
    scorer.meta = dict(scorer.meta, has_latent=False)
    try:
        with pytest.raises(ValueError, match="without latent"):
            scorer.score(feats, ok_cov, latent=True)
    finally:
        scorer.meta["has_latent"] = True


def test_loader_refuses_a_missing_program_or_card(artifact):
    with pytest.raises(ValueError, match="no cuda program"):
        export.load_scorer(artifact[0])


def test_format_guard_refuses_a_jax_artifact(jax_artifact, tmp_path):
    with pytest.raises(ValueError, match="unsupported artifact format"):
        export.load_scorer(jax_artifact, device="cpu")
    bogus = tmp_path / "bogus.mmnm"
    with zipfile.ZipFile(bogus, "w") as z:
        z.writestr(export.META_MEMBER, json.dumps({"format": "other/9"}))
    with pytest.raises(ValueError, match="unsupported artifact format"):
        export.load_scorer(bogus, device="cpu")


@pytest.mark.parametrize("platforms,match", [
    ("cuda", "no CUDA device"), ("cpu,tpu", "unknown"), (" ", "no programs")])
def test_platform_refusals(project, tmp_path, platforms, match):
    if platforms == "cuda" and torch.cuda.is_available():
        pytest.skip("a card is present: the cuda program exports")
    out = tmp_path / "m.mmnm"
    with pytest.raises(SystemExit, match=match):
        export.run(FLAGS + ["-o", str(out), "--platforms", platforms],
                   project_root=project)
    assert not out.exists()


def test_parser_keeps_the_jax_flags():
    port = {a.dest: a.default for a in export.build_parser()._actions}
    ref = {a.dest: a.default for a in jax_export.build_parser()._actions}
    assert set(port) == set(ref)
    assert port["platforms"] == "cpu,cuda"


_FRESH = """
import importlib.abc
import importlib.machinery
import sys

PORT = 'multi_modal_normative_modeling_tpu_torch'


def blocked(name):
    parts = name.split('.')
    return parts[0] in ('jax', 'flax', 'optax', 'sklearn',
                        'multi_modal_normative_modeling_tpu') or (
        parts[0] == PORT and len(parts) > 1
        and parts[1] in ('models', 'data', 'cli', 'infer'))


class Refuse(importlib.abc.Loader):
    def create_module(self, spec):
        raise ImportError('blocked for this check: ' + spec.name)

    def exec_module(self, module):
        pass


class Block:
    # a spec whose loading fails: find_spec probes (torch makes some)
    # see the module, importing it raises
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            return importlib.machinery.ModuleSpec(name, Refuse())
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
import io, json, zipfile
import numpy as np
import torch
import multi_modal_normative_modeling_tpu_torch.kernels  # registers mmnm::*

with zipfile.ZipFile(sys.argv[2]) as z:
    meta = json.loads(z.read('meta.json'))
    program = torch.export.load(io.BytesIO(
        z.read(meta['programs']['cpu']['scoring']))).module()
inputs = [torch.from_numpy(np.load(p)) for p in sys.argv[3:]]
rows = inputs[0].shape[0]
eps = torch.stack([torch.randn((rows, meta['latent_dim']),
                               generator=torch.Generator().manual_seed(s))
                   for s in meta['seeds']])
with torch.no_grad():
    devs, roi = program(*inputs, eps)
assert not [m for m in sys.modules if blocked(m)]
print(json.dumps(devs.mean(dim=(0, 1)).tolist()))
"""


def test_artifact_loads_in_a_fresh_process(artifact, scorer, service,
                                           tmp_path):
    """A process that imports torch and the port's kernels, and refuses
    jax, scikit-learn and the port's models, data, cli and infer,
    loads the program and scores a bucket-padded payload."""
    n = 4
    features, covariates = _payload(service,
                                    list(service._frames[0].index[:n]))
    paths = []
    for i, a in enumerate([*features.values(),
                           np.asarray(covariates["AGE"], np.float32),
                           np.asarray(covariates["PTGENDER"], np.float32)]):
        padded = np.pad(a, ((0, 64 - n),) + ((0, 0),) * (a.ndim - 1))
        paths.append(str(tmp_path / f"in{i}.npy"))
        np.save(paths[-1], padded)
    out = subprocess.run(
        [sys.executable, "-c", _FRESH, str(ROOT), str(artifact[0]), *paths],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    standalone = json.loads(out.stdout.strip().splitlines()[-1])[:n]
    expected = scorer.score(features, covariates)["deviation"]
    np.testing.assert_allclose(standalone, expected, rtol=1e-6)
