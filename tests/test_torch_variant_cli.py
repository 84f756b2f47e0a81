"""The supervised variants' own CLIs (nm-PM-cont, nm-MLP, the FI
regression) of the port against the JAX package's, on the CPU.

One tiny synthetic ADNI cohort with the FI column and the early-fusion
table (30 controls, 11 + 10 patients), ``-E 2 -K 2 -H 16 16 4``. Each JAX
CLI runs once (a module fixture); the port's runs with ``--device cpu``
from the JAX init (PRNGKey(42), every fold) and with the JAX draws replayed
through its hooks: the training noise, the end-to-end model's dropout keep
masks and the regression's per-epoch permutations
(``tests.test_torch_endtoend.jax_draws``), and the scoring noise
(PRNGKey(1000 + fold) for nm-MLP, 900 + fold and 800 + fold for the
regression's FI and ROI passes).

Held: the fold id files byte-equal; each checkpoint's json byte-equal, its
bytes those of flax's serialization of its tree, its parameters within the
trajectory bound (rtol 5e-3 / atol 1e-5; for the end-to-end model not the
classifier's pre-BatchNorm biases and running means, which Adam's sign
noise moves in fp32, tests/test_torch_endtoend.py); CSVs, ``.npy`` and
results_endtoend.csv's numbers rtol 1e-4 / atol 1e-5; the nm-MLP
``normalized_*`` CSVs and performance_metrics.txt byte-equal.
"""
import re
import shutil
import sys
import warnings

import jax
import numpy as np
import pandas as pd
import pytest
from flax import serialization

from multi_modal_normative_modeling_tpu.cli import (
    nmmlp as jax_nmmlp,
    nmpmcont as jax_nmpmcont,
    regression as jax_regression,
)
from multi_modal_normative_modeling_tpu.data.synthetic import (
    make_synthetic_resource,
)
from multi_modal_normative_modeling_tpu.models.endtoend import (
    EndToEndCVAE as JaxEndToEnd,
)
from multi_modal_normative_modeling_tpu.models.multimodal import (
    MultimodalCVAE as JaxMultimodal,
)
from multi_modal_normative_modeling_tpu.models.regression import (
    RegressionCVAE as JaxRegression,
)
from multi_modal_normative_modeling_tpu_torch.cli import (
    common,
    nmmlp,
    nmpmcont,
    regression,
)
from multi_modal_normative_modeling_tpu_torch.interop import (
    params_from_jax,
    read_flax_checkpoint,
)
from multi_modal_normative_modeling_tpu_torch.parallel import stack_params
from tests.test_torch_endtoend import _sign_noise_leaf, jax_draws
from tests.test_torch_threads import one_torch_thread  # noqa: F401

COMMON = ["-R", "ADNI", "-E", "2", "-K", "2", "-H", "16", "16", "4"]
FLAGS = {
    "nmpmcont": COMMON + ["-P", "SE-MoE", "-Layers", "16", "8"],
    "nmmlp": ["all"] + COMMON + ["-P", "SE-MoE"],
    # 26 and 25 test rows: train folds of 25 and 26 rows in batches of 25,
    # so the first fold has an all-padding second batch in the stacked grid
    "regression": COMMON + ["-P", "UCA-gPoE", "--batch_size", "25"],
}
JAX_CLIS = {"nmpmcont": jax_nmpmcont, "nmmlp": jax_nmmlp,
            "regression": jax_regression}
PORT_CLIS = {"nmpmcont": nmpmcont, "nmmlp": nmmlp, "regression": regression}
MODEL_DIR = "outputs/kfold_analysis/supervised_cvae"
CSV_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=5e-3, atol=1e-5)


def _jax_init(jax_model):
    """The JAX CLI's init: PRNGKey(42), the same tree for every fold."""
    def init(model):
        tree = jax.tree_util.tree_map(
            np.asarray, jax_model(model).init_params(jax.random.PRNGKey(42)))
        params_from_jax(stack_params([tree] * model.folds), model)
    return init


JAX_MODELS = {
    "nmpmcont": lambda m: JaxEndToEnd(
        m.input_dim_list, m.hidden_dim, m.latent_dim, m.c_dim, m.modalities,
        classifier_layers=m.classifier_layers, dropout_rate=0.5),
    "nmmlp": lambda m: JaxMultimodal(
        m.input_dim_list, m.hidden_dim, m.latent_dim, m.c_dim, m.modalities,
        variant="nmmlp"),
    "regression": lambda m: JaxRegression(
        m.input_dim_list, m.hidden_dim, m.latent_dim, m.c_dim,
        m.modalities),
}


def _draws(shuffle=False):
    def draws(valid, epochs, rows, model):
        return jax_draws(valid, epochs, rows, model.noise_dim,
                         getattr(model, "keep_widths", ()), shuffle=shuffle)
    return draws


def _normal_eps(seed, rows, z_dim):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                        (rows, z_dim)))


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("variant_data")
    make_synthetic_resource(root, "ADNI", n_hc=30, n_disease={0: 11, 1: 10},
                            with_fi=True, with_early_fusion=True)
    return root


@pytest.fixture(scope="module")
def runs(cohort, tmp_path_factory):
    """cli -> (JAX root, port root, JAX result, port result), each pair run
    once, on demand."""
    done = {}

    def run(cli):
        if cli not in done:
            roots = []
            for side in ("jax", "port"):
                root = tmp_path_factory.mktemp(f"{cli}_{side}") / "project"
                shutil.copytree(cohort / "data", root / "data")
                roots.append(root)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                ref = _run_jax(cli, roots[0])
                args = PORT_CLIS[cli].build_parser().parse_args(
                    FLAGS[cli] + ["--device", "cpu"])
                hooks = dict(init_fn=_jax_init(JAX_MODELS[cli]),
                             draws_fn=_draws(shuffle=cli == "regression"))
                if cli == "nmpmcont":
                    common.apply_post_parse_defaults(
                        args, default_procedure="SE-MoE")
                    got = nmpmcont.main(args, roots[1], **hooks)
                elif cli == "nmmlp":
                    got = nmmlp.main(
                        args, roots[1], eps_fn=lambda fold, rows, z:
                        _normal_eps(1000 + fold, rows, z), **hooks)
                else:
                    got = regression.train_and_test(
                        args, roots[1], eps_fn=_normal_eps, **hooks)
            done[cli] = (roots[0], roots[1], ref, got)
        return done[cli]

    return run


def _run_jax(cli, root):
    """The JAX CLI's ``run`` with its result kept (``run`` drops it)."""
    module = JAX_CLIS[cli]
    args = module.build_parser().parse_args(FLAGS[cli])
    if cli == "nmpmcont":
        common.apply_post_parse_defaults(args, default_procedure="SE-MoE")
        return module.main(args, project_root=root)
    if cli == "regression":
        return module.train_and_test(args, project_root=root)
    args.combine = args.procedure.split("-")[1]
    module.train(args, root)
    module.test(args, root)
    return module.analyze(args, root)


def _same_bytes(a, b, rel):
    assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


def _close_csv(got_path, ref_path):
    ref = pd.read_csv(ref_path)
    got = pd.read_csv(got_path)
    assert list(got.columns) == list(ref.columns), ref_path.name
    assert got.shape == ref.shape, ref_path.name
    numeric = ref.select_dtypes("number").columns
    other = [c for c in ref.columns if c not in set(numeric)]
    pd.testing.assert_frame_equal(got[other], ref[other])
    np.testing.assert_allclose(got[numeric].to_numpy(np.float64),
                               ref[numeric].to_numpy(np.float64),
                               err_msg=ref_path.name, **CSV_TOL)


def _check_checkpoints(jax_root, port_root, skip=lambda path: False):
    for fold in range(2):
        rel = f"{MODEL_DIR}/{fold:03d}"
        _same_bytes(jax_root, port_root, f"{rel}/cVAE_model.json")
        got, _ = read_flax_checkpoint(port_root / rel)
        ref, _ = read_flax_checkpoint(jax_root / rel)
        # the port's writer is flax's byte format
        assert (port_root / rel / "cVAE_model.ckpt").read_bytes() == \
            serialization.to_bytes(got)
        assert (jax.tree_util.tree_structure(got)
                == jax.tree_util.tree_structure(ref))
        for path, want in jax.tree_util.tree_leaves_with_path(ref):
            name = jax.tree_util.keystr(path)
            leaf = got
            for p in path:
                leaf = leaf[p.key if hasattr(p, "key") else p.idx]
            assert np.isfinite(leaf).all(), name
            if not skip(name):
                np.testing.assert_allclose(leaf, want, err_msg=name,
                                           **PARAM_TOL)


def _ids(root, kind_dir):
    return sorted(p.name for p in (root / "outputs" / kind_dir).glob("*.csv"))


# ---- nm-PM-cont ------------------------------------------------------------

def test_nmpmcont_matches_the_jax_cli(runs):
    jax_root, port_root, ref, got = runs("nmpmcont")
    # ids generated into kfold_analysis_endtoend, read back from there
    assert _ids(port_root, "kfold_analysis_endtoend") == [
        "test_ids_000.csv", "test_ids_001.csv", "train_ids_000.csv",
        "train_ids_001.csv"]
    assert not (port_root / "outputs" / "kfold_analysis"
                / "train_ids_000.csv").exists()
    for name in _ids(jax_root, "kfold_analysis_endtoend"):
        _same_bytes(jax_root, port_root,
                    f"outputs/kfold_analysis_endtoend/{name}")
    _check_checkpoints(jax_root, port_root, skip=_sign_noise_leaf)
    pd.testing.assert_frame_equal(got, ref, rtol=1e-4, atol=1e-5)
    ref_lines = (jax_root / "results_endtoend.csv").read_text().split("\n")
    got_lines = (port_root / "results_endtoend.csv").read_text().split("\n")
    # the args line: the port's flags are the JAX CLI's plus --device
    assert got_lines[0].replace("device='cpu', ", "") == ref_lines[0]
    # the args, one line per metric, three blank lines and the end
    assert len(got_lines) == len(ref_lines) == 1 + 5 + 3 + 1
    number = re.compile(r"-?\d+\.\d+|nan")
    for a, b in zip(got_lines[1:], ref_lines[1:]):
        assert number.sub("#", a) == number.sub("#", b)
        np.testing.assert_allclose(
            [float(v) for v in number.findall(a)],
            [float(v) for v in number.findall(b)], **CSV_TOL)


# ---- nm-MLP ----------------------------------------------------------------

def test_nmmlp_matches_the_jax_cli(runs):
    jax_root, port_root, ref, got = runs("nmmlp")
    for name in _ids(jax_root, "kfold_analysis"):
        _same_bytes(jax_root, port_root, f"outputs/kfold_analysis/{name}")
    _check_checkpoints(jax_root, port_root)
    files = sorted(p.relative_to(jax_root)
                   for p in (jax_root / MODEL_DIR).rglob("*.csv"))
    assert len(files) == 2 * (3 * 3 + 1)
    assert files == sorted(p.relative_to(port_root)
                           for p in (port_root / MODEL_DIR).rglob("*.csv"))
    for rel in files:
        if rel.name.startswith("normalized_"):
            _same_bytes(jax_root, port_root, rel)
        else:
            _close_csv(port_root / rel, jax_root / rel)
    _same_bytes(jax_root, port_root,
                "outputs/analysis_results/performance_metrics.txt")
    assert got["auc"] == ref["auc"] and got["auc_std"] == ref["auc_std"]


def test_nmmlp_trains_on_controls_against_ad_only(runs, cohort):
    """The fold ids split the controls and the AD group (DIA 0) only, and
    each fold's checkpoint was trained on its controls."""
    _, port_root, _, _ = runs("nmmlp")
    y = pd.read_csv(cohort / "data" / "ADNI" / "y.csv").set_index("IID")
    ids = pd.concat([pd.read_csv(port_root / "outputs" / "kfold_analysis"
                                 / f"{kind}_ids_{f:03d}.csv")
                     for kind in ("train", "test") for f in range(2)])
    assert set(y.loc[ids["IID"], "DIA"]) == {0, 2}


# ---- the regression -----------------------------------------------------------

def test_regression_matches_the_jax_cli(runs):
    jax_root, port_root, ref, got = runs("regression")
    out = "regression_outputs"
    names = sorted(p.name for p in (jax_root / out).glob("*.npy"))
    assert names == sorted(p.name for p in (port_root / out).glob("*.npy"))
    assert len(names) == 4
    for name in names:
        a = np.load(port_root / out / name)
        b = np.load(jax_root / out / name)
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        if "true" in name:
            assert np.array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, err_msg=name, **CSV_TOL)
    csvs = sorted(p.name for p in (jax_root / out).glob("*.csv"))
    assert len(csvs) == 2 * 4
    assert csvs == sorted(p.name for p in (port_root / out).glob("*.csv"))
    for name in csvs:
        _close_csv(port_root / out / name, jax_root / out / name)
    assert len(got) == len(ref) == 2
    for a, b in zip(got, ref):
        assert set(a) == set(b) == {"RMSE", "MAE", "R2", "MAPE"}
        for k in a:
            np.testing.assert_allclose(a[k], b[k], err_msg=k, **CSV_TOL)


def test_regression_draws_the_jax_scatter(runs, tmp_path, monkeypatch,
                                          capsys):
    """Where matplotlib is present the port draws the JAX CLI's
    fold_<k>_scatter.png; where it is absent (the machine with the GPU) it
    draws none and says so (the .npy pair holds the figure's data)."""
    jax_root, port_root, _, _ = runs("regression")
    out = "regression_outputs"
    names = ["fold_0_scatter.png", "fold_1_scatter.png"]
    assert sorted(p.name for p in (jax_root / out).glob("*.png")) == names
    assert sorted(p.name for p in port_root.rglob("*.png")) == names
    assert sorted(p.name for p in (port_root / out).glob("*.png")) == names

    root = tmp_path / "project"
    shutil.copytree(port_root / "data", root / "data")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    args = regression.build_parser().parse_args(
        FLAGS["regression"] + ["--device", "cpu"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scores = regression.train_and_test(args, root)
    assert len(scores) == 2
    assert ("matplotlib is not installed: skipping the FI scatter plots"
            in capsys.readouterr().out)
    assert len(list((root / out).glob("*.npy"))) == 4
    assert not list(root.rglob("*.png"))


# ---- flags -----------------------------------------------------------------------

NOT_PORTED = [
    (cli, flag, value, item)
    for cli, flags in (("nmpmcont", ("packed_xla", "ep_mesh", "mesh",
                                     "checkpoint_every", "resume")),
                       ("nmmlp", ("packed_xla", "mesh", "checkpoint_every",
                                  "resume")),
                       ("regression", ("packed_xla", "mesh",
                                       "checkpoint_every", "resume")))
    for flag, value, item in (
        ("packed_xla", True, "'Packed layout' and 'Grouped layout'"),
        ("ep_mesh", "2,2,2", "'Multi-device'"),
        ("mesh", "2,4", "'Multi-device'"),
        ("checkpoint_every", 5, "'Resume'"),
        ("resume", True, "'Resume'"))
    if flag in flags]


@pytest.mark.parametrize("cli,flag,value,item", NOT_PORTED)
def test_unported_flags_exit_citing_their_queue_item(cli, flag, value, item,
                                                     tmp_path, cohort):
    args = PORT_CLIS[cli].build_parser().parse_args(
        FLAGS[cli] + ["--device", "cpu"])
    if cli == "nmpmcont":
        common.apply_post_parse_defaults(args, default_procedure="SE-MoE")
    setattr(args, flag, value)
    main = (regression.train_and_test if cli == "regression"
            else PORT_CLIS[cli].main)
    if flag == "checkpoint_every":
        # queue 1 item 'Resume' is ported: the run keeps one whole-run
        # train state in its state dir
        shutil.copytree(cohort / "data", tmp_path / "data")
        main(args, tmp_path)
        state_dir = tmp_path / ("regression_outputs" if cli == "regression"
                                else MODEL_DIR)
        assert (state_dir / "train_state.ckpt").exists()
        return
    if flag == "packed_xla":
        # queue 1 items 'Packed layout' and 'Grouped layout' are ported:
        # the run trains on its packed layout
        # (tests/test_torch_packed_variants.py holds it to the per-modality
        # run)
        shutil.copytree(cohort / "data", tmp_path / "data")
        main(args, tmp_path)
        if cli == "regression":
            assert len(list((tmp_path / "regression_outputs")
                            .glob("fold_*_pred.npy"))) == 2
        else:
            for fold in range(2):
                assert (tmp_path / MODEL_DIR / f"{fold:03d}"
                        / "cVAE_model.ckpt").exists()
        return
    match = f"--{flag}.*queue 1 item.*{re.escape(item)}"
    if flag == "mesh":
        # ported (tests/test_torch_mesh_cli.py runs the variants on a mesh
        # of ranks): without --fold_parallel it exits with the JAX message
        match = "--mesh requires --fold_parallel"
    if flag == "resume":
        # ported, and refused without --checkpoint_every (the JAX message)
        match = "--resume requires --checkpoint_every N"
    if flag == "ep_mesh":
        # ported (tests/test_torch_ep_cli.py trains nmpmcont --ep_mesh on
        # ranks): 8 slots in a world of one rank, the JAX message
        match = "--ep_mesh 2,2,2: 8 mesh slots != 1 visible devices"
    with pytest.raises(SystemExit, match=match):
        main(args, tmp_path)
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("cli", list(PORT_CLIS))
def test_parsers_take_the_jax_flags_and_default_to_cuda(cli, tmp_path):
    argv = FLAGS[cli] + ["--fold_parallel"]
    args = PORT_CLIS[cli].build_parser().parse_args(argv)
    ref = vars(JAX_CLIS[cli].build_parser().parse_args(argv))
    assert args.device == "cuda" and args.fold_parallel
    assert {k: v for k, v in vars(args).items() if k != "device"} == ref
    with pytest.raises(SystemExit, match="no CUDA device"):
        (regression.train_and_test if cli == "regression"
         else PORT_CLIS[cli].main)(args, tmp_path)
