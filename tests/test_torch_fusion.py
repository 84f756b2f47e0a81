"""In-memory early fusion (--in_memory_fusion) in the port, on the CPU.

``common.fuse_preps`` and the fused branch of ``common.prepare_folds`` are
held to the JAX package's bit for bit on the same inputs. Then a UCA-gPoE
cohort (tests/test_uca_pipeline.py's, 2 folds) trains and scores through
the port's train and test stages on each training path (the plain loss,
--fused_decoder, --fused_train_step; their plain versions on the CPU),
reading early_fusion_modalities_ADNI.csv, and again with --in_memory_fusion
with the CSV present and with it deleted: the deviation CSVs must match the
file-based run at tests/test_uca_pipeline.py:77-79's bound (rtol 1e-5, atol
1e-8). One in-memory run is killed and resumed."""
import argparse
import shutil

import numpy as np
import pandas as pd
import pytest

from multi_modal_normative_modeling_tpu.cli import common as jax_common
from multi_modal_normative_modeling_tpu.data.synthetic import (
    make_synthetic_resource,
)
from multi_modal_normative_modeling_tpu_torch import registry
from multi_modal_normative_modeling_tpu_torch.cli import (
    common,
    test_supervised,
    train_supervised,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

FUSED = "early_fusion_modalities_ADNI"
NAMES = registry.get_datasets_name("ADNI", "UCA-gPoE")
MODEL_DIR = "outputs/kfold_analysis/supervised_cvae"
DEV_DIR = "deviation/supervised_cvae/ADNI/UCA-gPoE/path_model"
PATHS = {"plain": {}, "fused_decoder": {"fused_decoder": True},
         "fused_train_step": {"fused_train_step": True}}
EPOCHS = 4
TOL = dict(rtol=1e-5, atol=1e-8)


def _args(**extra):
    base = dict(
        dataset_resourse="ADNI", hz_para_list=[16, 16, 6],
        procedure="UCA-gPoE", combine="gPoE", epochs=EPOCHS, n_splits=2,
        oversample_percentage=1, model="cVAE_multimodal",
        single_modality=None, base_learning_rate=0.0001,
        max_learning_rate=0.005, training_class="nm",
        lr_schedule="constant", fold_parallel=True, precision="fp32",
        device="cpu")
    base.update(extra)
    return argparse.Namespace(**base)


def _cohort(root, with_csv=True):
    make_synthetic_resource(root, "ADNI", n_hc=40, n_disease={0: 20, 1: 20},
                            effect=0.9, with_early_fusion=True, seed=5)
    if not with_csv:
        (root / "data" / "ADNI" / f"{FUSED}.csv").unlink()
    return root


def _error_csv(root, name):
    return pd.read_csv(root / DEV_DIR / name
                       / f"reconstruction_error_{name}.csv")


@pytest.fixture(scope="module")
def preps(tmp_path_factory):
    """The three base modalities' preps of fold 0 (train and test split),
    from the port's prepare_modality."""
    root = _cohort(tmp_path_factory.mktemp("preps"))
    common.generate_kfold_ids(*_groups(root), n_splits=2, project_root=root)
    kfold = root / "outputs" / "kfold_analysis"
    return root, common.prepare_fold_modalities(
        root, "ADNI", NAMES[:-1], root / "data" / "ADNI" / "y.csv",
        [common.fold_paths(kfold, f) for f in range(2)])


def _groups(root):
    y = pd.read_csv(root / "data" / "ADNI" / "y.csv")
    return y[y["DIA"] == 2], y[y["DIA"] != 2]


@pytest.mark.parametrize("split", ["train", "train_and_test"])
def test_fuse_preps_is_the_jax_function(preps, split):
    _, per_fold = preps
    base = per_fold[0]
    if split == "train":
        base = [{k: v for k, v in p.items() if not k.startswith("test")}
                for p in base]
    got = common.fuse_preps(base, NAMES[:-1], "ADNI")
    ref = jax_common.fuse_preps(base, NAMES[:-1], "ADNI")
    assert sorted(got) == sorted(ref)
    for key, value in ref.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype
            np.testing.assert_array_equal(got[key], value)
        elif isinstance(value, pd.DataFrame):
            assert got[key] is value
        else:
            assert got[key] == value
    assert got["train_data"].shape[1] == 270
    assert got["columns"][0].endswith("_av45")


def test_fuse_preps_keeps_the_qcut_error():
    def prep(err):
        out = {"columns": ["a"], "train_df": None,
               "train_data": np.zeros((2, 1), np.float32),
               "train_cov": np.zeros((2, 3), np.float32),
               "test_df": None, "test_data": np.zeros((1, 1)),
               "test_cov": None if err else np.zeros((1, 3))}
        if err:
            out["test_cov_error"] = "Bin edges must be unique"
        return out

    fused = common.fuse_preps([prep(False), prep(True)], ["m0", "m1"], "X")
    assert fused["test_cov"] is None
    assert fused["test_cov_error"] == "Bin edges must be unique"
    with pytest.raises(ValueError, match="Bin edges must be unique"):
        common.require_test_cov(fused, "fold 0")
    ref = jax_common.fuse_preps([prep(False), prep(True)], ["m0", "m1"],
                                "X")
    assert sorted(fused) == sorted(ref)
    assert ref["test_cov_error"] == fused["test_cov_error"]


@pytest.mark.parametrize("with_csv", [True, False], ids=["csv", "no_csv"])
def test_prepare_folds_is_the_jax_function(tmp_path, with_csv):
    root = _cohort(tmp_path / "project", with_csv)
    common.generate_kfold_ids(*_groups(root), n_splits=2, project_root=root)
    kfold = root / "outputs" / "kfold_analysis"
    args = _args(in_memory_fusion=True)
    got = common.prepare_folds(args, root, kfold, kfold / "port", NAMES,
                               root / "data" / "ADNI" / "y.csv")
    ref = jax_common.prepare_folds(args, root, kfold, kfold / "jax", NAMES,
                                   root / "data" / "ADNI" / "y.csv")
    assert got[1:] == ref[1:] == ([90, 90, 90, 270], 29)
    for (data, cov), (ref_data, ref_cov) in zip(got[0], ref[0]):
        for a, b in zip(data + cov, ref_data + ref_cov):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_in_memory_fusion_only_on_a_uca_procedure():
    assert common.in_memory_fusion(_args(in_memory_fusion=True))
    assert not common.in_memory_fusion(_args())
    assert not common.in_memory_fusion(_args(in_memory_fusion=True,
                                             procedure="SE-gPoE"))


def _run(root, path, **extra):
    args = _args(**PATHS[path], **extra)
    train_supervised.main(args, project_root=root)
    test_supervised.main(args, project_root=root)


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """Per training path: the file-based chain, and --in_memory_fusion with
    the early-fusion CSV present and deleted."""
    base = tmp_path_factory.mktemp("fusion")
    out = {}
    for path in PATHS:
        for mode, mem, with_csv in (("file", False, True),
                                    ("csv", True, True),
                                    ("no_csv", True, False)):
            root = _cohort(base / f"{path}_{mode}", with_csv)
            _run(root, path, in_memory_fusion=mem)
            out[path, mode] = root
    return out


@pytest.mark.parametrize("mode", ["csv", "no_csv"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_in_memory_fusion_matches_the_file_based_run(chains, path, mode):
    ref_root, root = chains[path, "file"], chains[path, mode]
    for name in NAMES:
        ref, got = _error_csv(ref_root, name), _error_csv(root, name)
        assert list(got.columns) == list(ref.columns)
        pd.testing.assert_frame_equal(got.iloc[:, :4], ref.iloc[:, :4])
        np.testing.assert_allclose(got["Reconstruction error"],
                                   ref["Reconstruction error"], **TOL,
                                   err_msg=f"{path} {mode} {name}")
    roi = pd.read_csv(root / DEV_DIR / FUSED
                      / f"reconstruction_error_roi_{FUSED}.csv")
    assert roi.shape[1] == 4 + 270 and roi.columns[4].endswith("_av45")
    config = (root / MODEL_DIR / "000" / "cVAE_model.json").read_text()
    assert '"input_dim_list": [\n  90,\n  90,\n  90,\n  270\n ]' in config


def test_in_memory_fusion_resumes(chains, tmp_path):
    """Killed after 2 of 4 epochs and resumed, an in-memory run writes the
    straight run's checkpoints byte for byte; a file-based run's state
    resumes under --in_memory_fusion (the fingerprint is the same)."""
    root = _cohort(tmp_path / "killed", with_csv=False)
    _run(root, "plain", in_memory_fusion=True, epochs=2, checkpoint_every=2)
    _run(root, "plain", in_memory_fusion=True, checkpoint_every=2,
         resume=True)
    for fold in range(2):
        rel = f"{MODEL_DIR}/{fold:03d}/cVAE_model.ckpt"
        assert ((root / rel).read_bytes()
                == (chains["plain", "no_csv"] / rel).read_bytes())
    mixed = _cohort(tmp_path / "mixed")
    _run(mixed, "plain", epochs=2, checkpoint_every=2)
    _run(mixed, "plain", in_memory_fusion=True, checkpoint_every=2,
         resume=True)
    np.testing.assert_allclose(
        _error_csv(mixed, FUSED)["Reconstruction error"],
        _error_csv(chains["plain", "file"], FUSED)["Reconstruction error"],
        **TOL)
    shutil.rmtree(mixed)
