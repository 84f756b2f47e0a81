"""--mesh on the port's CLIs, on the CPU: two ranks (torch.multiprocessing
spawn, gloo on 127.0.0.1) against the port's unmeshed runs.

The ranks meet over a file store (``file://``), so no two test processes
race for a port. One small ADNI project (SE-MoE, 3 modalities, 2 folds of 25 and 26
subjects, batch 6: the last batch of each fold is ragged, and on the
'data' axis one rank holds only padding rows of it) is trained unmeshed,
scored by the test stage and by the score CLI. One spawn of two ranks then
runs, each rank the same CLI calls:

  * the train CLI with --fold_parallel --mesh 1,2 (data), 2,1 (folds) and
    1,1,2 (tensor, hidden 22 22 4: 11 columns a rank), each into a copy of the project;
  * --stream_shards 2 --mesh 1,2, against the resident --mesh 1,2 run;
  * the test stage with --mesh 1,2 and 2,1 on copies of the trained
    project, and the score CLI with --mesh 1,2;
  * the supervised variants' CLIs on a cohort with the FI column: nm-MLP
    ``all`` with --fold_parallel --mesh 1,2 (the scoring stage too), nm-PM-
    cont with --mesh 1,2 (its classifier's BatchNorm over the whole batch,
    whose rows both ranks hold some of) and the regression
    with --mesh 2,1 (a data axis is refused: the shuffle crosses it).

Bounds: the JAX tests' own (tests/test_fold_parallel_cli.py): checkpoints
rtol 2e-4 / atol 2e-5, CSVs and scores rtol 1e-5 / atol 1e-7; the streamed
meshed run equals the resident meshed one bit for bit. Rank 0 writes every
file: the other rank's copies hold none it would have written alone. The
end-to-end model's pre-BatchNorm biases and running means are left out, as
tests/test_torch_variant_cli.py leaves them out: their gradient is zero
but for rounding, and Adam turns its sign into lr-sized steps."""
import argparse
import os
import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
import torch.multiprocessing as mp

from multi_modal_normative_modeling_tpu_torch.cli import (
    bootstrap,
    common,
    nmmlp,
    nmpmcont,
    regression,
    score as port_score,
    test_supervised as port_test,
    train_supervised as port_train,
)
from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
    make_synthetic_resource,
)
from multi_modal_normative_modeling_tpu_torch.interop import (
    read_flax_checkpoint,
)
from multi_modal_normative_modeling_tpu_torch.parallel import distributed
from tests.test_torch_threads import one_torch_thread  # noqa: F401

MODEL_DIR = "outputs/kfold_analysis/supervised_cvae"
DEV_DIR = "deviation/supervised_cvae/ADNI/SE-MoE/path_model"
TRAIN_TOL = dict(rtol=2e-4, atol=2e-5)
CSV_TOL = dict(rtol=1e-5, atol=1e-7)
TRAIN_MESHES = {"d12": "1,2", "f21": "2,1", "m112": "1,1,2"}
VARIANT_COMMON = ["-R", "ADNI", "-E", "2", "-K", "2", "-H", "22", "22", "4",
                  "--device", "cpu"]
VARIANTS = {
    "nmmlp": (["all"] + VARIANT_COMMON + ["-P", "SE-MoE"], "1,2"),
    "nmpmcont": (VARIANT_COMMON + ["-P", "SE-MoE", "-Layers", "16", "8"],
                 "1,2"),
    "regression": (VARIANT_COMMON + ["-P", "UCA-gPoE", "--batch_size", "26"],
                   "2,1"),
}
# the bootstrap chain: its replicates over 'fold', rows over 'data' (the
# train and the test stage)
BOOTSTRAP = {"bootstrap": (["all", "-R", "ADNI", "-B", "4", "-E", "2", "-H",
                            "22", "22", "4", "--device", "cpu"], "1,2")}
BOOT_DIR = "outputs/bootstrap_analysis"


def _train_args(**extra):
    base = dict(dataset_resourse="ADNI", hz_para_list=[22, 22, 4],
                procedure="SE-MoE", combine="MoE", epochs=3, n_splits=2,
                oversample_percentage=1, model="cVAE_multimodal",
                single_modality=None, base_learning_rate=0.0001,
                max_learning_rate=0.005, training_class="nm",
                lr_schedule="constant", fold_parallel=True, precision="fp32",
                batch_size=6, device="cpu")
    base.update(extra)
    return argparse.Namespace(**base)


def _test_args(**extra):
    base = dict(dataset_resourse="ADNI", hz_para_list=[22, 22, 4],
                procedure="SE-MoE", combine="MoE", n_splits=2, device="cpu",
                emit_latent=False)
    base.update(extra)
    return argparse.Namespace(**base)


def _score_args(root, out, **extra):
    return port_score.build_parser().parse_args(
        ["-R", "ADNI", "-P", "SE-MoE", "-K", "2", "--device", "cpu",
         "--ids", str(root / "ids.csv"), "--output", str(out),
         "--roi_output", str(out.with_suffix(".roi.csv"))] + [
            a for k, v in extra.items() for a in (f"--{k}", v)])


def rendezvous(directory) -> str:
    """The file of a spawn's store: file:// init leaves no port for two
    test processes to race for."""
    return str(Path(directory) / "rendezvous")


def join_world(rank: int, world: int, store: str) -> None:
    """Rank ``rank`` of a local world of ``world``: torchrun's variables,
    one torch thread, the process group over the store file. At exit the
    rank leaves the group with the others (``distributed.shutdown``: a
    barrier, then the groups destroyed), so no rank tears down its gloo
    connections while a peer still uses them."""
    import atexit

    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    distributed.initialize_distributed(f"file://{store}", world, rank)
    atexit.register(distributed.shutdown)


def _ranks(rank, world, store, base):
    join_world(rank, world, store)
    base = Path(base)
    # the JAX messages a world of two reaches (before any collective)
    with pytest.raises(SystemExit, match="not divisible"):
        common.parse_mesh("2,1", n_folds=3, batch_size=256)
    with pytest.raises(SystemExit, match="not divisible"):
        common.parse_mesh("1,2", n_folds=2, batch_size=5)
    for name, spec in TRAIN_MESHES.items():
        port_train.main(_train_args(mesh=spec), project_root=base / name)
    port_train.main(_train_args(mesh="1,2", fold_parallel=False,
                                stream_shards=2),
                    project_root=base / "s12")
    for name, spec in (("t12", "1,2"), ("t21", "2,1")):
        port_test.main(_test_args(mesh=spec), project_root=base / name)
    port_score.score(_score_args(base / "plain", base / "meshed_scores.csv",
                                 mesh="1,2"), project_root=base / "plain")
    for name, (argv, spec) in VARIANTS.items():
        _variant(name, argv + ["--fold_parallel", "--mesh", spec],
                 base / f"{name}_mesh")
    for name, (argv, spec) in BOOTSTRAP.items():
        bootstrap.main(bootstrap.build_parser().parse_args(
            argv + ["--mesh", spec]), project_root=base / f"{name}_mesh")
    with pytest.raises(SystemExit, match="shuffles every fold"):
        _variant("regression", VARIANTS["regression"][0]
                 + ["--fold_parallel", "--mesh", "1,2"], base / "refused")


def _variant(name, argv, root):
    """A variant CLI's main on ``argv`` (nm-PM-cont's post-parse defaults
    as its run() applies them)."""
    cli = {"nmmlp": nmmlp, "nmpmcont": nmpmcont,
           "regression": regression}[name]
    args = cli.build_parser().parse_args(argv)
    if name == "nmpmcont":
        common.apply_post_parse_defaults(args, default_procedure="SE-MoE")
    main = regression.train_and_test if name == "regression" else cli.main
    main(args, project_root=root)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("mesh_cli")
    plain = base / "plain"
    make_synthetic_resource(plain, "ADNI", n_hc=30, n_disease={0: 11, 1: 10})
    for name in list(TRAIN_MESHES) + ["s12"]:
        shutil.copytree(plain / "data", base / name / "data")
    port_train.main(_train_args(), project_root=plain)
    for name in ("t12", "t21"):
        shutil.copytree(plain, base / name)
    port_test.main(_test_args(), project_root=plain)
    y = pd.read_csv(plain / "data" / "ADNI" / "y.csv")
    y[["IID"]].to_csv(plain / "ids.csv", index=False)
    port_score.score(_score_args(plain, plain / "scores.csv"),
                     project_root=plain)
    # nm-PM-cont's batch is 256: folds of 135 training rows put real rows
    # on both ranks of its data axis (7 on rank 1), so the whole batch's
    # BatchNorm statistics differ from either rank's own
    make_synthetic_resource(base / "variant_cohort", "ADNI", n_hc=150,
                            n_disease={0: 60, 1: 60}, with_fi=True,
                            with_early_fusion=True)
    for name, (argv, _) in {**VARIANTS, **BOOTSTRAP}.items():
        for suffix in ("", "_mesh"):
            shutil.copytree(base / "variant_cohort" / "data",
                            base / f"{name}{suffix}" / "data")
        if name in VARIANTS:
            _variant(name, argv, base / name)
    bootstrap.main(bootstrap.build_parser().parse_args(
        BOOTSTRAP["bootstrap"][0]), project_root=base / "bootstrap")
    mp.spawn(_ranks, args=(2, rendezvous(base), str(base)), nprocs=2)
    return base


def _params(root, fold):
    params, _ = read_flax_checkpoint(root / MODEL_DIR / f"{fold:03d}")
    return params


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, np.asarray(tree)


@pytest.mark.parametrize("name", sorted(TRAIN_MESHES))
def test_meshed_training_matches_unmeshed(runs, name):
    for fold in (0, 1):
        want = dict(_leaves(_params(runs / "plain", fold)))
        got = dict(_leaves(_params(runs / name, fold)))
        assert sorted(got) == sorted(want)
        for path in want:
            np.testing.assert_allclose(got[path], want[path],
                                       err_msg=f"{name} fold {fold} {path}",
                                       **TRAIN_TOL)
    # the files rank 0 wrote are the unmeshed train stage's set (the
    # plain project's CSVs are its test stage's)
    def written(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                      if p.is_file() and p.suffix != ".csv")

    assert written(runs / name / MODEL_DIR) == written(
        runs / "plain" / MODEL_DIR)


def test_streamed_mesh_equals_resident_mesh(runs):
    for fold in (0, 1):
        a = (runs / "s12" / MODEL_DIR / f"{fold:03d}" / "cVAE_model.ckpt")
        b = (runs / "d12" / MODEL_DIR / f"{fold:03d}" / "cVAE_model.ckpt")
        assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("name", ["t12", "t21"])
def test_meshed_test_stage_csvs_match_unmeshed(runs, name):
    plain = {p.relative_to(runs / "plain"): p
             for p in (runs / "plain").rglob("*.csv")
             if p.relative_to(runs / "plain").parts[0] in ("outputs",
                                                         "deviation")}
    assert any("path_model" in p.parts for p in plain)
    for rel, path in plain.items():
        want = pd.read_csv(path)
        got = pd.read_csv(runs / name / rel)
        assert list(got.columns) == list(want.columns), rel
        num = want.select_dtypes("number").columns
        np.testing.assert_allclose(got[num].values, want[num].values,
                                   err_msg=str(rel), **CSV_TOL)


def test_meshed_score_cli_matches_unmeshed(runs):
    plain = runs / "plain"
    for suffix in (".csv", ".roi.csv"):
        want = pd.read_csv((plain / "scores.csv").with_suffix(suffix))
        got = pd.read_csv((runs / "meshed_scores.csv").with_suffix(suffix))
        assert list(got.columns) == list(want.columns)
        assert (got["participant_id"] == want["participant_id"]).all()
        num = want.select_dtypes("number").columns
        np.testing.assert_allclose(got[num].values, want[num].values,
                                   **CSV_TOL)


def test_mesh_flag_validation_matches_jax(tmp_path):
    """The JAX tests' messages (tests/test_fold_parallel_cli.py:142-160)
    hold for the port: one rank here."""
    with pytest.raises(SystemExit, match="fold_parallel"):
        port_train.main(_train_args(fold_parallel=False, mesh="2,4"),
                        project_root=tmp_path)
    with pytest.raises(SystemExit, match="visible devices"):
        common.parse_mesh("3,5", n_folds=3, batch_size=256)
    with pytest.raises(SystemExit, match="positive"):
        common.parse_mesh("-1,-1", n_folds=10, batch_size=256)
    with pytest.raises(SystemExit, match="visible devices"):
        port_test.main(_test_args(mesh="3,5"), project_root=tmp_path)


def _sign_noise(path: str) -> bool:
    """The end-to-end classifier's pre-BatchNorm biases and its running
    means (tests/test_torch_endtoend.py:426-428)."""
    return (("/blocks/" in path and path.endswith("/linear/b"))
            or (path.startswith("/bn_state/") and path.endswith("/mean")))


@pytest.mark.parametrize("name", ["nmmlp", "nmpmcont"])
def test_meshed_variant_training_matches_unmeshed(runs, name):
    for fold in (0, 1):
        want = dict(_leaves(_params(runs / name, fold)))
        got = dict(_leaves(_params(runs / f"{name}_mesh", fold)))
        assert sorted(got) == sorted(want)
        for path in want:
            if name == "nmpmcont" and _sign_noise(path):
                continue
            np.testing.assert_allclose(got[path], want[path],
                                       err_msg=f"{name} {fold} {path}",
                                       **TRAIN_TOL)


@pytest.mark.parametrize("name,pattern", [
    ("nmmlp", "outputs/kfold_analysis/supervised_cvae/*/**/*.csv"),
    ("nmpmcont", "results_endtoend.csv"),
    ("regression", "regression_outputs/*.csv")])
def test_meshed_variant_outputs_match_unmeshed(runs, name, pattern):
    paths = sorted((runs / name).glob(pattern))
    assert paths
    if name == "nmpmcont":
        # the run's flags, then its metrics as text (mean and std)
        want = paths[0].read_text().splitlines()
        got = (runs / f"{name}_mesh" / pattern).read_text().splitlines()
        assert "mesh='1,2'" in got[0] and got[1:] == want[1:]
        return
    for path in paths:
        rel = path.relative_to(runs / name)
        want, got = pd.read_csv(path), pd.read_csv(runs / f"{name}_mesh"
                                                   / rel)
        assert list(got.columns) == list(want.columns), rel
        num = want.select_dtypes("number").columns
        np.testing.assert_allclose(got[num].values, want[num].values,
                                   err_msg=str(rel), **CSV_TOL)
    if name == "regression":
        for path in sorted((runs / name).glob("regression_outputs/*.npy")):
            np.testing.assert_allclose(
                np.load(runs / f"{name}_mesh" / path.relative_to(
                    runs / name)), np.load(path), **CSV_TOL)


def test_meshed_bootstrap_matches_unmeshed(runs):
    """--mesh 1,2: every replicate's checkpoint at the training bound, its
    deviation CSV and bootstrap_auc.csv at the CSV bound."""
    want_root, got_root = runs / "bootstrap", runs / "bootstrap_mesh"
    ckpts = sorted((want_root / BOOT_DIR).glob("*/*/cVAE_model.ckpt"))
    assert len(ckpts) == 4
    for ckpt in ckpts:
        rel = ckpt.parent.relative_to(want_root)
        want = dict(_leaves(read_flax_checkpoint(ckpt.parent)[0]))
        got = dict(_leaves(read_flax_checkpoint(got_root / rel)[0]))
        for path in want:
            np.testing.assert_allclose(got[path], want[path],
                                       err_msg=f"{rel} {path}", **TRAIN_TOL)
    csvs = sorted(want_root.glob(f"{BOOT_DIR}/**/*.csv"))
    assert any(p.name.startswith("deviation_") for p in csvs)
    for path in csvs + [want_root / "bootstrap_auc.csv"]:
        rel = path.relative_to(want_root)
        want, got = pd.read_csv(path), pd.read_csv(got_root / rel)
        assert list(got.columns) == list(want.columns), rel
        num = want.select_dtypes("number").columns
        np.testing.assert_allclose(got[num].values, want[num].values,
                                   err_msg=str(rel), **CSV_TOL)
