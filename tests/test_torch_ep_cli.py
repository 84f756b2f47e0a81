"""--ep_mesh on the port's CLIs, on the CPU: two ranks (torch.multiprocessing
spawn, gloo over a file store) against the port's unmeshed runs.

Two small projects: ADHD (SE-gPoE, two modalities of one width: one
modality a rank) and ADNI with its early-fusion modality (UCA-gPoE, widths
3 x W + 3W: the width groups of 3 and 1 modalities stay whole on a 2-way
modality axis, the [M] leaves split). Each is trained unmeshed on its
packed layout (``--packed_xla``, the layout ``--ep_mesh`` trains) and
scored by the test stage. One spawn of two ranks then runs:

  * the train CLI with --ep_mesh 2,1 (``EPFoldTrainer``) and 1,2,1 (the
    packed trainer with ``packed_fold_shardings``) on ADHD, and 1,2,1 on
    ADNI (``grouped_fold_shardings``);
  * --ep_mesh 2,1 killed after 2 of 4 epochs and resumed, against the
    straight 4-epoch run;
  * the test stage with --ep_mesh 1,2,1 on copies of both unmeshed
    projects, each rank's K1/K2 calls counted (one of each per modality it
    owns), the pipeline with --ep_mesh 2,1, and nm-PM-cont with --ep_mesh
    1,2,1 against its unmeshed --packed_xla run.

Bounds: the JAX tests' own, checkpoints rtol 2e-4 / atol 2e-5, CSVs rtol
1e-5 / atol 1e-7; the resumed run equals the straight one byte for byte.
The gates' messages are the JAX CLIs' (cli/train_supervised.py:180-254,
cli/common.py:579-609), checked in-process on one rank."""
import argparse
import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch.multiprocessing as mp

from multi_modal_normative_modeling_tpu_torch.cli import (
    common,
    nmpmcont,
    pipeline,
    test_supervised as port_test,
    train_supervised as port_train,
)
from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
    make_synthetic_resource,
)
from tests.test_torch_mesh_cli import (
    _leaves,
    _params,
    join_world,
    rendezvous,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

MODEL_DIR = "outputs/kfold_analysis/supervised_cvae"
TRAIN_TOL = dict(rtol=2e-4, atol=2e-5)
CSV_TOL = dict(rtol=1e-5, atol=1e-7)
PROJECTS = {"adhd": ("ADHD", "SE-gPoE"), "adni": ("ADNI", "UCA-gPoE")}
# (project, --ep_mesh) of each meshed train run
TRAIN_RUNS = {"adhd_21": ("adhd", "2,1"), "adhd_121": ("adhd", "1,2,1"),
              "adni_121": ("adni", "1,2,1")}
NMPMCONT = ["-R", "ADNI", "-P", "SE-MoE", "-E", "2", "-K", "2", "-H", "12",
            "12", "4", "-Layers", "16", "8", "--device", "cpu"]


def _train_args(project, **extra):
    resource, procedure = PROJECTS[project]
    base = dict(dataset_resourse=resource, hz_para_list=[12, 12, 4],
                procedure=procedure, combine="gPoE", epochs=3, n_splits=2,
                oversample_percentage=1, model="cVAE_multimodal",
                single_modality=None, base_learning_rate=0.0001,
                max_learning_rate=0.005, training_class="nm",
                lr_schedule="constant", precision="fp32", batch_size=8,
                device="cpu")
    base.update(extra)
    return argparse.Namespace(**base)


def _test_args(project, **extra):
    resource, procedure = PROJECTS[project]
    base = dict(dataset_resourse=resource, hz_para_list=[12, 12, 4],
                procedure=procedure, combine="gPoE", n_splits=2,
                device="cpu", emit_latent=False)
    base.update(extra)
    return argparse.Namespace(**base)


def _ranks(rank, world, store, base):
    join_world(rank, world, store)
    base = Path(base)
    for name, (project, spec) in TRAIN_RUNS.items():
        port_train.main(_train_args(project, ep_mesh=spec),
                        project_root=base / name)
    port_train.main(_train_args("adhd", ep_mesh="2,1", epochs=4),
                    project_root=base / "straight")
    port_train.main(_train_args("adhd", ep_mesh="2,1", epochs=2,
                                checkpoint_every=1),
                    project_root=base / "resumed")
    port_train.main(_train_args("adhd", ep_mesh="2,1", epochs=4,
                                checkpoint_every=1, resume=True),
                    project_root=base / "resumed")
    from multi_modal_normative_modeling_tpu_torch.models import cvae

    counts = {}
    for project in PROJECTS:
        calls = {}
        saved = (cvae.Encoder.fused, cvae.Decoder.fused_pred_deviation)
        _patch_counts(cvae, calls)
        port_test.main(_test_args(project, ep_mesh="1,2,1"),
                       project_root=base / f"{project}_test")
        cvae.Encoder.fused, cvae.Decoder.fused_pred_deviation = saved
        counts[project] = calls
    (base / f"counts{rank}.txt").write_text(repr(counts))
    args = pipeline.build_parser().parse_args(
        ["-R", "ADHD", "-P", "SE-gPoE", "-E", "3", "-K", "2", "-H", "12",
         "12", "4", "--batch_size", "8", "--device", "cpu", "--ep_mesh",
         "2,1"])
    common.apply_post_parse_defaults(args)
    pipeline.main(args, project_root=base / "pipeline")
    args = nmpmcont.build_parser().parse_args(NMPMCONT
                                              + ["--ep_mesh", "1,2,1"])
    common.apply_post_parse_defaults(args, default_procedure="SE-MoE")
    nmpmcont.main(args, project_root=base / "nmpmcont_ep")


def _patch_counts(cvae, calls):
    enc, dec = cvae.Encoder.fused, cvae.Decoder.fused_pred_deviation

    def fused(self, *a, **k):
        calls["K1"] = calls.get("K1", 0) + 1
        return enc(self, *a, **k)

    def fused_pred_deviation(self, *a, **k):
        calls["K2"] = calls.get("K2", 0) + 1
        return dec(self, *a, **k)

    cvae.Encoder.fused = fused
    cvae.Decoder.fused_pred_deviation = fused_pred_deviation


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("ep_cli")
    make_synthetic_resource(base / "adhd", "ADHD", n_hc=30,
                            n_disease={0: 10, 2: 10})
    make_synthetic_resource(base / "adni", "ADNI", n_hc=30,
                            n_disease={0: 10, 1: 10},
                            with_early_fusion=True)
    for name, (project, _) in TRAIN_RUNS.items():
        shutil.copytree(base / project / "data", base / name / "data")
    for name in ("straight", "resumed", "pipeline"):
        shutil.copytree(base / "adhd" / "data", base / name / "data")
    for project in PROJECTS:
        port_train.main(_train_args(project, packed_xla=True),
                        project_root=base / project)
        shutil.copytree(base / project, base / f"{project}_test")
        port_test.main(_test_args(project), project_root=base / project)
    make_synthetic_resource(base / "nmpmcont", "ADNI", n_hc=30,
                            n_disease={0: 10, 1: 10}, with_fi=True)
    shutil.copytree(base / "nmpmcont" / "data", base / "nmpmcont_ep" / "data")
    args = nmpmcont.build_parser().parse_args(NMPMCONT + ["--packed_xla"])
    common.apply_post_parse_defaults(args, default_procedure="SE-MoE")
    nmpmcont.main(args, project_root=base / "nmpmcont")
    mp.spawn(_ranks, args=(2, rendezvous(base), str(base)), nprocs=2)
    return base


def _close_checkpoints(got_root, want_root, skip=lambda path: False):
    for fold in (0, 1):
        want = dict(_leaves(_params(want_root, fold)))
        got = dict(_leaves(_params(got_root, fold)))
        assert sorted(got) == sorted(want)
        for path in want:
            if not skip(path):
                np.testing.assert_allclose(
                    got[path], want[path], err_msg=f"fold {fold} {path}",
                    **TRAIN_TOL)


@pytest.mark.parametrize("name", sorted(TRAIN_RUNS))
def test_ep_training_matches_the_unmeshed_packed_run(runs, name):
    _close_checkpoints(runs / name, runs / TRAIN_RUNS[name][0])


def test_ep_resume_equals_the_straight_run(runs):
    for fold in (0, 1):
        a = runs / "resumed" / MODEL_DIR / f"{fold:03d}" / "cVAE_model.ckpt"
        b = runs / "straight" / MODEL_DIR / f"{fold:03d}" / "cVAE_model.ckpt"
        assert a.read_bytes() == b.read_bytes()
    assert (runs / "resumed" / MODEL_DIR / "ep-state").is_dir()


def _csvs_close(got_root, want_root):
    files = [p for p in want_root.rglob("*.csv")
             if p.relative_to(want_root).parts[0] in ("outputs",
                                                      "deviation")]
    assert any("path_model" in p.parts for p in files)
    for path in files:
        rel = path.relative_to(want_root)
        want, got = pd.read_csv(path), pd.read_csv(got_root / rel)
        assert list(got.columns) == list(want.columns), rel
        num = want.select_dtypes("number").columns
        np.testing.assert_allclose(got[num].values, want[num].values,
                                   err_msg=str(rel), **CSV_TOL)


@pytest.mark.parametrize("project", sorted(PROJECTS))
def test_ep_test_stage_matches_unmeshed(runs, project):
    """Every CSV of the stage at the JAX bound; each rank calls K1 and K2
    once per modality it owns (ADHD: one of 2; ADNI: two of 4)."""
    _csvs_close(runs / f"{project}_test", runs / project)
    owned = {"adhd": 1, "adni": 2}[project]
    for rank in (0, 1):
        counts = eval((runs / f"counts{rank}.txt").read_text())
        assert counts[project] == {"K1": owned, "K2": owned}


def test_ep_pipeline_is_the_ep_train_and_test_stages(runs):
    for fold in (0, 1):
        a = runs / "pipeline" / MODEL_DIR / f"{fold:03d}" / "cVAE_model.ckpt"
        b = runs / "straight" / MODEL_DIR / f"{fold:03d}" / "cVAE_model.ckpt"
        assert a.exists() and b.exists()
    _close_checkpoints(runs / "pipeline", runs / "adhd_21")
    assert list((runs / "pipeline" / "deviation").rglob("*.csv"))


def test_ep_nmpmcont_matches_its_packed_run(runs):
    from tests.test_torch_mesh_cli import _sign_noise

    _close_checkpoints(runs / "nmpmcont_ep", runs / "nmpmcont", _sign_noise)


# ---- the gates, one rank ---------------------------------------------------------

DIVISIBILITY = [((2, 2, 2), 10, 256, 4), ((3, 2, 1), 10, 256, 4),
                ((1, 3, 1), 10, 256, 4), ((4, 2), 10, 256, 6),
                ((2, 3), 10, 256, 4), ((2, 2), 10, 255, 4),
                ((1, 2, 2), 10, 255, 4)]


@pytest.mark.parametrize("sizes,folds,batch,modalities", DIVISIBILITY)
@pytest.mark.parametrize("dual", [False, True])
def test_ep_divisibility_messages_match_jax(sizes, folds, batch, modalities,
                                            dual):
    from multi_modal_normative_modeling_tpu.cli import common as jcommon

    kwargs = (dict(modality_axis_len=2 * modalities,
                   modality_axis_desc="dual-bank axis 2M") if dual else {})
    assert common.ep_mesh_divisibility(
        list(sizes), folds, batch, modalities, **kwargs) == \
        jcommon.ep_mesh_divisibility(list(sizes), folds, batch, modalities,
                                     **kwargs)


GATES = [
    (dict(mesh="1,1", fold_parallel=True),
     "--ep_mesh is mutually exclusive with --mesh, --fold_parallel"),
    (dict(fold_parallel=True),
     "--ep_mesh is mutually exclusive with --fold_parallel"),
    (dict(packed_xla=True, fused_train_step=True),
     "--ep_mesh is mutually exclusive with --packed_xla, --fused_train_step"),
    (dict(model="DMVAE"),
     "--ep_mesh supports the cvae skeleton only (cvae/mmjsd/mvtcae/nmmlp)"),
    (dict(precision="bf16", model="mmJSD"),
     "--ep_mesh unavailable (bf16 packed path is cvae-only (the mmjsd/"
     "mvtcae regularizers have no half-precision parity story))"),
    (dict(precision="bf16"), "--ep_mesh 1,1: EP trainer is fp32 "
                             "(parity path)"),
]


@pytest.mark.parametrize("extra,message", GATES)
def test_ep_gates_exit_with_the_jax_text(extra, message, tmp_path):
    """The JAX CLI's texts (cli/train_supervised.py:192-254), with the
    M,D mesh of one rank: every gate exits before a step is taken."""
    make_synthetic_resource(tmp_path, "ADHD", n_hc=20,
                            n_disease={0: 8, 2: 8})
    with pytest.raises(SystemExit) as info:
        port_train.main(_train_args("adhd", ep_mesh="1,1", **extra),
                        project_root=tmp_path)
    assert str(info.value) == message
    assert not (tmp_path / MODEL_DIR / "000" / "cVAE_model.ckpt").exists()


def test_ep_spec_messages_match_jax(tmp_path):
    with pytest.raises(SystemExit) as info:
        port_train.main(_train_args("adhd", ep_mesh="1,1,1,1"),
                        project_root=tmp_path)
    assert str(info.value) == ("--ep_mesh takes 2 or 3 axis sizes: 4,2 "
                               "(modality,data) or 2,2,2 "
                               "(fold,modality,data)")
    with pytest.raises(SystemExit) as info:
        port_test.main(_test_args("adhd", ep_mesh="1,1", mesh="1,1"),
                       project_root=tmp_path)
    assert str(info.value) == "--ep_mesh is mutually exclusive with --mesh"
    args = nmpmcont.build_parser().parse_args(NMPMCONT
                                              + ["--ep_mesh", "1,1"])
    common.apply_post_parse_defaults(args, default_procedure="SE-MoE")
    with pytest.raises(SystemExit) as info:
        nmpmcont.main(args, project_root=tmp_path)
    assert str(info.value) == ("--ep_mesh takes 3 axis sizes: 2,2,2 "
                               "(fold,modality,data)")
