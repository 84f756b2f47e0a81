"""The port's own copies of the data layer, the emitters and the run log
against their originals in the JAX package, on the same numpy-seeded inputs
and one ``make_synthetic_resource`` project: tables equal, arrays bit-equal,
frames equal, files byte-equal."""
import inspect
import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from multi_modal_normative_modeling_tpu import registry as jax_registry
from multi_modal_normative_modeling_tpu import viz as jax_viz
from multi_modal_normative_modeling_tpu.cli import (
    early_fusion as jax_early_fusion,
)
from multi_modal_normative_modeling_tpu.data import (
    loading as jax_loading,
    preprocess as jax_preprocess,
    synthetic as jax_synthetic,
)
from multi_modal_normative_modeling_tpu.infer import (
    deviation as jax_deviation,
    emitters as jax_emitters,
)
from multi_modal_normative_modeling_tpu.utils import logging as jax_logging
from multi_modal_normative_modeling_tpu_torch import registry, viz
from multi_modal_normative_modeling_tpu_torch.cli import early_fusion
from multi_modal_normative_modeling_tpu_torch.data import (
    loading,
    preprocess,
    synthetic,
)
from multi_modal_normative_modeling_tpu_torch.infer import deviation, emitters
from multi_modal_normative_modeling_tpu_torch.utils import logging
from tests.test_torch_threads import one_torch_thread  # noqa: F401

RESOURCES = ("ADNI", "HCP", "ADHD", "PPMI", "HCPimage")
PROCEDURES = ("SE-PoE", "SE-MoE", "UCA-gPoE", "SM-av45", "VS-PoE")


@pytest.fixture(scope="module")
def projects(tmp_path_factory):
    """The same synthetic ADNI project written by each package's
    generator: (the JAX package's root, the port's root)."""
    roots = []
    for name, module in (("jax", jax_synthetic), ("port", synthetic)):
        root = tmp_path_factory.mktemp(name)
        module.make_synthetic_resource(root, "ADNI", n_hc=30,
                                       n_disease={0: 10, 1: 10}, seed=3)
        roots.append(root)
    return roots


def _files(root):
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


# ---- registry -------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "COLUMNS_NAME", "COLUMNS_NAME_VBM", "COLUMNS_NAME_SNP",
    "COLUMNS_NAME_AAL116", "BASE_MODALITIES", "HC_LABELS",
    "HC_PATIENT_COMBINATIONS"])
def test_registry_tables_equal(name):
    assert getattr(registry, name) == getattr(jax_registry, name)


@pytest.mark.parametrize("resource", RESOURCES)
def test_registry_functions_equal(resource):
    assert registry.get_hc_label(resource) == jax_registry.get_hc_label(
        resource)
    for procedure in PROCEDURES:
        try:
            want = jax_registry.get_datasets_name(resource, procedure)
        except (KeyError, ValueError) as exc:
            with pytest.raises(type(exc)):
                registry.get_datasets_name(resource, procedure)
            continue
        assert registry.get_datasets_name(resource, procedure) == want
        for dataset in want:
            assert registry.get_column_name(resource, dataset) == \
                jax_registry.get_column_name(resource, dataset)


# ---- synthetic cohorts ------------------------------------------------------------

def test_synthetic_project_files_byte_equal(projects):
    a, b = map(_files, projects)
    assert list(a) == list(b) and a
    assert a == b


@pytest.mark.parametrize("resource,kwargs", [
    ("ADHD", {}), ("ADNI", {"with_fi": True, "with_early_fusion": True,
                            "label_noise": 0.25})])
def test_synthetic_variants_byte_equal(tmp_path, resource, kwargs):
    for name, module in (("jax", jax_synthetic), ("port", synthetic)):
        module.make_synthetic_resource(tmp_path / name, resource, n_hc=12,
                                       seed=5, **kwargs)
    assert _files(tmp_path / "jax") == _files(tmp_path / "port")


# ---- scaling and covariates --------------------------------------------------------

@pytest.mark.parametrize("shape,seed", [((40, 7), 0), ((5, 90), 1),
                                        ((120, 3), 2)])
def test_fit_robust_scaler_bit_equal(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * rng.uniform(0.1, 30.0, shape[1])
    x[:, 0] = 4.0                      # a zero-IQR column: scale 1.0
    scaled, params = preprocess.fit_robust_scaler(x)
    want, want_params = jax_preprocess.fit_robust_scaler(x)
    assert np.array_equal(scaled, want)
    assert np.array_equal(params.center, want_params.center)
    assert np.array_equal(params.scale, want_params.scale)
    assert np.array_equal(params.inverse_transform(scaled),
                          want_params.inverse_transform(want))


def test_fit_robust_scaler_raises_on_nan():
    x = np.ones((6, 3))
    x[2, 1] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        preprocess.fit_robust_scaler(x)


@pytest.mark.parametrize("rows,seed,strings", [(60, 0, False), (31, 1, False),
                                               (29, 2, True)])
def test_one_hot_covariates_bit_equal(rows, seed, strings):
    """Train-set binning and the test-set re-binning quirk (Q5): the test
    rows are binned on themselves, so a subset bins differently."""
    rng = np.random.default_rng(seed)
    gender = rng.integers(1, 3, rows)
    cov = pd.DataFrame({
        "AGE": np.round(rng.uniform(55, 90, rows), 1),
        "PTGENDER": np.where(gender == 1, "F", "M") if strings else gender})
    for frame in (cov, cov.iloc[rows // 3:].reset_index(drop=True)):
        got = preprocess.one_hot_covariates(frame)
        want = jax_preprocess.one_hot_covariates(frame)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)
    assert not np.array_equal(
        preprocess.one_hot_covariates(cov)[rows // 3:],
        preprocess.one_hot_covariates(
            cov.iloc[rows // 3:].reset_index(drop=True)))


def _train_and_new_cov(kind, rng):
    """(train cohort, new subjects) covariate frames: ``numeric`` ages over
    quantile edges (new ages below, between and above the train range),
    ``low`` a cohort whose AGE has at most 27 distinct values (nearest
    train value), ``strings`` a string-coded gender (identity)."""
    n = 60
    gender = rng.integers(1, 3, n)
    ages = (np.round(rng.uniform(55, 90, n), 1) if kind != "low"
            else rng.choice([60.0, 65.0, 70.0, 75.0], n))
    train = pd.DataFrame({"AGE": ages, "PTGENDER": (
        np.where(gender == 1, "F", "M") if kind == "strings" else gender)})
    new_ages = np.array([40.0, 55.0, 61.3, 67.4, 70.0, 88.8, 95.0, 72.5])
    new_gender = np.array([1, 2, 2, 1, 1, 2, 1, 2])
    new = pd.DataFrame({"AGE": new_ages, "PTGENDER": (
        np.where(new_gender == 1, "F", "M") if kind == "strings"
        else new_gender)})
    return train, new


@pytest.mark.parametrize("kind", ["numeric", "low", "strings"])
def test_train_binned_covariates_bit_equal(kind):
    """The scoring surfaces' covariates: new subjects binned by the train
    cohort's quantile edges, nearest train value, or category identity;
    one subject at a time gives the rows of the whole batch."""
    train, new = _train_and_new_cov(kind, np.random.default_rng(7))
    got = preprocess.train_binned_covariates(train, new)
    want = jax_preprocess.train_binned_covariates(train, new)
    assert got.dtype == want.dtype == np.float32 and got.shape == (8, 29)
    assert np.array_equal(got, want)
    assert (got.sum(axis=1) == 2.0).all()
    for i in range(len(new)):
        one = new.iloc[i:i + 1].reset_index(drop=True)
        assert np.array_equal(preprocess.train_binned_covariates(train, one),
                              got[i:i + 1])


@pytest.mark.parametrize("case,match", [
    ("unseen category", "not in the training cohort categories"),
    ("too many categories", "exceed the 2 covariate bins")])
def test_train_binned_covariates_errors_equal(case, match):
    train, new = _train_and_new_cov("strings", np.random.default_rng(8))
    if case == "unseen category":
        new.loc[3, "PTGENDER"] = "X"
    else:
        train.loc[:2, "PTGENDER"] = ["X", "Y", "Z"]
    messages = []
    for module in (preprocess, jax_preprocess):
        with pytest.raises(ValueError, match=match) as err:
            module.train_binned_covariates(train, new)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


# ---- loading ---------------------------------------------------------------------------

def _ids_file(root, rng, tmp_path):
    y = pd.read_csv(root / "data" / "ADNI" / "y.csv")
    ids = rng.choice(y["IID"].to_numpy(), size=40, replace=True)
    path = tmp_path / "ids.csv"
    pd.DataFrame({"IID": ids}).to_csv(path, index=False)
    return path


def test_load_demographic_data_and_dataset_equal(projects, tmp_path):
    root = projects[1]
    data_dir = root / "data" / "ADNI"
    ids = _ids_file(root, np.random.default_rng(0), tmp_path)
    got = loading.load_demographic_data(data_dir / "y.csv", ids)
    want = jax_loading.load_demographic_data(data_dir / "y.csv", ids)
    pd.testing.assert_frame_equal(got, want)
    assert len(got) == 40
    modality = registry.get_datasets_name("ADNI", "SE-MoE")[0]
    pd.testing.assert_frame_equal(
        loading.load_dataset(data_dir / "y.csv", ids,
                             data_dir / f"{modality}.csv"),
        jax_loading.load_dataset(data_dir / "y.csv", ids,
                                 data_dir / f"{modality}.csv"))


@pytest.mark.parametrize("fmt", ["two_part", "three_part"])
def test_load_demographic_data_composite_ids_equal(tmp_path, fmt):
    rng = np.random.default_rng(7)
    n = 12
    demo = pd.DataFrame({
        "participant_id": [f"sub-{i:03d}" for i in range(n)],
        "Session_ID": [f"ses-{i % 2 + 1}" for i in range(n)],
        "DIA": rng.integers(0, 3, n), "AGE": rng.uniform(60, 80, n),
        "PTGENDER": rng.integers(1, 3, n)})
    uid = demo["participant_id"] + "_" + demo["Session_ID"]
    if fmt == "three_part":
        demo["Run_ID"] = rng.integers(1, 3, n)
        uid = uid + "_run-" + demo["Run_ID"].astype(str)
    demo.to_csv(tmp_path / "y.csv", index=False)
    pd.DataFrame({"IID": (uid + "_extra").sample(
        frac=1.0, random_state=1)}).to_csv(tmp_path / "ids.csv", index=False)
    got = loading.load_demographic_data(tmp_path / "y.csv",
                                        tmp_path / "ids.csv")
    want = jax_loading.load_demographic_data(tmp_path / "y.csv",
                                             tmp_path / "ids.csv")
    pd.testing.assert_frame_equal(got, want)
    assert len(got) == n


@pytest.mark.parametrize("case", ["unique_right", "unique_left", "many_many",
                                  "shared_column", "nan_keys"])
def test_fast_inner_merge_equal(case):
    rng = np.random.default_rng(11)
    keys = np.array([f"s{i:02d}" for i in range(20)], dtype=object)
    left = pd.DataFrame({"IID": rng.choice(keys, 30), "a": rng.random(30)})
    right = pd.DataFrame({"IID": rng.permutation(keys)[:15],
                          "b": rng.random(15)})
    if case == "unique_left":
        left, right = right.rename(columns={"b": "a"}), left.rename(
            columns={"a": "b"})
    elif case == "many_many":
        right = pd.concat([right, right.iloc[:4]], ignore_index=True)
    elif case == "shared_column":
        right["a"] = 1.0
    elif case == "nan_keys":
        left.loc[3, "IID"] = None
    got = loading.fast_inner_merge(left, right)
    pd.testing.assert_frame_equal(got, jax_loading.fast_inner_merge(left,
                                                                    right))
    pd.testing.assert_frame_equal(got, pd.merge(left, right, on="IID"))


# ---- deviation and emitters -----------------------------------------------------------------

def test_deviation_functions_bit_equal():
    rng = np.random.default_rng(5)
    x, pred = rng.standard_normal((2, 9, 13))
    assert np.array_equal(deviation.reconstruction_deviation(x, pred),
                          jax_deviation.reconstruction_deviation(x, pred))
    assert np.array_equal(
        deviation.reconstruction_deviation_roi(x, pred),
        jax_deviation.reconstruction_deviation_roi(x, pred))


@pytest.mark.parametrize("name", [
    "reconstruction_deviation", "reconstruction_deviation_roi",
    "latent_deviation", "separate_latent_deviation", "_ols_pvalues",
    "_logit_pvalues", "latent_pvalues"])
def test_deviation_functions_are_the_originals(name):
    """Each function of the copy is the original's text, so what
    tests/test_latent_pvalues_golden.py holds for one holds for both;
    tests/test_torch_latent.py compares their values."""
    assert inspect.getsource(getattr(deviation, name)) == \
        inspect.getsource(getattr(jax_deviation, name))


# ---- the copies of slice 12: the export's binning spec, viz's tables ------------------------

@pytest.mark.parametrize("module,jax_module,name", [
    (preprocess, jax_preprocess, "binned_covariate_graph_spec"),
    (viz, jax_viz, "roi_deviation_table"),
    (viz, jax_viz, "auc_summary_table"),
    (viz, jax_viz, "aal90_centroids"),
    (viz, jax_viz, "brain_outlines")])
def test_slice_12_copies_are_the_originals(module, jax_module, name):
    """The text of each copied function is the original's (their values:
    tests/test_torch_export.py, tests/test_torch_report.py)."""
    assert inspect.getsource(getattr(module, name)) == \
        inspect.getsource(getattr(jax_module, name))


@pytest.mark.parametrize("name", ["aal90_mni_centroids.json",
                                  "brain_outline_2d.json"])
def test_vendored_geometry_byte_equal(name):
    port = Path(preprocess.__file__).with_name(name)
    original = Path(jax_preprocess.__file__).with_name(name)
    assert port.read_bytes() == original.read_bytes()


def test_latent_deviation_values_bit_equal():
    rng = np.random.default_rng(6)
    mu_train, mu_test = rng.standard_normal((2, 30, 4))
    var_test = np.exp(rng.standard_normal((30, 4)))
    for name in ("latent_deviation", "separate_latent_deviation"):
        assert np.array_equal(
            getattr(deviation, name)(mu_train, mu_test, var_test),
            getattr(jax_deviation, name)(mu_train, mu_test, var_test))


# ---- early fusion ---------------------------------------------------------------------------

def test_early_fusion_csv_byte_equal(projects):
    """cli/early_fusion.py of both packages on the same project: the same
    file, every base modality's columns suffixed with its name."""
    out = []
    for module, root in zip((jax_early_fusion, early_fusion), projects):
        path = module.build_early_fusion(root, "ADNI")
        assert path == (root / "data" / "ADNI"
                        / "early_fusion_modalities_ADNI.csv")
        out.append(path.read_bytes())
        path.unlink()
    assert out[0] and out[0] == out[1]
    module_run = []
    for module, root in zip((jax_early_fusion, early_fusion), projects):
        module.run(["-R", "ADNI"], project_root=root)
        path = root / "data" / "ADNI" / "early_fusion_modalities_ADNI.csv"
        module_run.append(path.read_bytes())
        frame = pd.read_csv(path)
        path.unlink()
    assert module_run == out
    names = registry.get_datasets_name("ADNI")
    assert frame.columns[0] == "IID"
    assert len(frame.columns) == 1 + sum(
        len(registry.get_column_name("ADNI", n)) for n in names)
    assert all(c.endswith(tuple(f"_{n}" for n in names))
               for c in frame.columns[1:])


def test_early_fusion_refuses_misaligned_modalities(projects, tmp_path):
    root = tmp_path / "project"
    (root / "data").mkdir(parents=True)
    import shutil

    shutil.copytree(projects[1] / "data" / "ADNI", root / "data" / "ADNI")
    last = registry.get_datasets_name("ADNI")[-1]
    path = root / "data" / "ADNI" / f"{last}.csv"
    frame = pd.read_csv(path)
    frame.iloc[::-1].to_csv(path, index=False)
    for module in (early_fusion, jax_early_fusion):
        with pytest.raises(ValueError, match="IID order differs"):
            module.build_early_fusion(root, "ADNI")


def _emit(module, out, names, columns):
    rng = np.random.default_rng(9)
    with module.DeviationEmitter(names) as emitter:
        for fold in range(2):
            for name in names:
                rows = 7 + fold
                cov = pd.DataFrame({
                    "participant_id": [f"sub-{fold}{i}" for i in range(rows)],
                    "DIA": rng.integers(0, 3, rows),
                    "AGE": np.round(rng.uniform(55, 90, rows), 1),
                    "PTGENDER": rng.integers(1, 3, rows),
                    "unused": 0})
                x = rng.standard_normal((rows, len(columns[name])))
                pred = x + 0.1 * rng.standard_normal(x.shape).astype(
                    np.float32)
                dev = deviation.reconstruction_deviation(x, pred)
                emitter.emit_fold(out / f"{fold:03d}", name, columns[name],
                                  cov, x, pred, dev)
        emitter.emit_combined(out / "all")


def test_deviation_emitter_csvs_byte_equal(tmp_path):
    names = registry.get_datasets_name("ADNI", "SE-MoE")
    columns = {n: registry.get_column_name("ADNI", n) for n in names}
    _emit(jax_emitters, tmp_path / "jax", names, columns)
    _emit(emitters, tmp_path / "port", names, columns)
    a, b = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert len(a) == 5 * len(names) * 3
    assert a == b


def test_write_csv_byte_equal(tmp_path):
    rng = np.random.default_rng(2)
    frame = pd.DataFrame({"participant_id": ["a", "b,c", 'd"e'],
                          "v": rng.standard_normal(3),
                          "w": rng.standard_normal(3).astype(np.float32),
                          "n": [1, 2, 3]})
    jax_emitters.write_csv(tmp_path / "a.csv", frame)
    emitters.write_csv(tmp_path / "b.csv", frame)
    assert (tmp_path / "a.csv").read_bytes() == (
        tmp_path / "b.csv").read_bytes()


# ---- run log and loss history ------------------------------------------------------------------

def test_run_log_files_equal(tmp_path, monkeypatch):
    ticks = iter(np.arange(100.0, 200.0, 0.5))
    monkeypatch.setattr(jax_logging.time, "time", lambda: next(ticks))
    events = [("start", {"folds": 2, "dims": [90, 90]}),
              ("fold", {"fold": 0, "path": tmp_path / "x",
                        "loss": np.float32(1.5)}),
              ("done", {})]
    for module, name in ((jax_logging, "jax"), (logging, "port")):
        ticks = iter(np.arange(100.0, 200.0, 0.5))
        log = module.RunLog(tmp_path / name / "run_log.jsonl")
        for kind, fields in events:
            log.event(kind, **fields)
    a = (tmp_path / "jax" / "run_log.jsonl").read_text()
    assert a == (tmp_path / "port" / "run_log.jsonl").read_text()
    assert [json.loads(line)["event"] for line in a.splitlines()] == [
        "start", "fold", "done"]


def test_logger_history_equal():
    rng = np.random.default_rng(1)
    logs = {k: rng.standard_normal(6) for k in ("total", "kl", "ll")}
    a, b = jax_logging.Logger(), logging.Logger()
    for lg in (a, b):
        lg.extend(logs)
        lg.on_train_init(["extra"])
        lg.on_step_fi({"extra": 2.0})
    assert a.logs == b.logs


def test_plot_losses_png_equal(tmp_path):
    pytest.importorskip("matplotlib")
    logs = {k: np.random.default_rng(1).standard_normal(6)
            for k in ("total", "kl")}
    out = []
    for module, name in ((jax_logging, "jax"), (logging, "port")):
        lg = module.Logger()
        lg.extend(logs)
        (tmp_path / name).mkdir()
        module.plot_losses(lg, tmp_path / name, "training")
        out.append((tmp_path / name / "Lossestraining.png").read_bytes())
    assert out[0] and out[0] == out[1]
