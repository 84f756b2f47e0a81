"""The port's bootstrap CLI against the JAX bootstrap CLI, on the CPU.

The cohort of tests/test_bootstrap.py (ADNI, 50 healthy controls, 20 of
disease 0, no early-fusion CSV, so ``-D 3modalities`` is fused in memory)
goes through JAX's ``bootstrap all`` and the port's (``--device cpu``, -B 3
-E 2 -H 16 16 4). The port must write the same id files; train from the
JAX init on the JAX noise (PRNGKey(1000 + b) per replicate, replayed) to
checkpoints within the trainer bound (rtol 5e-3, atol 1e-5); score the JAX
checkpoints on the JAX scoring noise (PRNGKey(2000 + b)) to deviation CSVs
within the test stage's bound (rtol 1e-4, atol 1e-5); and, on the JAX test
stage's CSVs, write the same bootstrap_auc.csv and report lines."""
import shutil

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from multi_modal_normative_modeling_tpu.cli import bootstrap as jax_boot
from multi_modal_normative_modeling_tpu.data.synthetic import (
    make_synthetic_resource,
)
from multi_modal_normative_modeling_tpu_torch.cli import bootstrap
from multi_modal_normative_modeling_tpu_torch.interop import (
    read_flax_checkpoint,
)
from multi_modal_normative_modeling_tpu_torch.train.checkpoints import (
    train_state_exists,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_train import jax_eps_replay
from tests.test_torch_train_cli import _jax_init

BOOT = "outputs/bootstrap_analysis"
REPS = 3
FLAGS = ["-R", "ADNI", "-D", "3modalities", "-E", "2", "-B", str(REPS),
         "-H", "16", "16", "4"]
VARIANTS = {"cvae": [], "vae": ["--unconditioned"]}


def _args(action, parser, extra=()):
    return parser.parse_args([action] + FLAGS + list(extra))


def _port_args(action, extra=()):
    return _args(action, bootstrap.build_parser(),
                 ["--device", "cpu", *extra])


def jax_train_eps(reps):
    """The noise JAX's bootstrap trainer draws, replicate b from
    PRNGKey(1000 + b): eps_fn(valid [F, NB], epochs, rows, z)."""
    def eps_fn(valid, epochs, rows, z_dim):
        return np.concatenate([
            jax_eps_replay(valid[i:i + 1], epochs, rows, z_dim,
                           key=jax.random.PRNGKey(1000 + b))
            for i, b in enumerate(reps)], axis=1)
    return eps_fn


def jax_score_eps(replicate, padded_rows, z_dim):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(2000 + replicate),
                                        (padded_rows, z_dim)))


def _model_dir(variant):
    return f"{BOOT}/supervised_{variant}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per variant: the JAX chain, the port's chain (JAX init and draws),
    the port's test stage on the JAX checkpoints and the port's analysis
    on the JAX test stage's CSVs."""
    base = tmp_path_factory.mktemp("bootstrap")
    make_synthetic_resource(base / "jax", "ADNI", n_hc=50,
                            n_disease={0: 20})
    out = {"base": base}
    for variant, extra in VARIANTS.items():
        jax_boot.main(_args("all", jax_boot.build_parser(), extra),
                      project_root=base / "jax")
        port = base / f"port_{variant}"
        shutil.copytree(base / "jax" / "data", port / "data")
        bootstrap.create_ids(_port_args("create_ids", extra),
                             project_root=port)
        bootstrap.train(_port_args("train", extra), project_root=port,
                        init_fn=_jax_init, eps_fn=jax_train_eps(range(REPS)))
        scored = base / f"scored_{variant}"
        shutil.copytree(base / "jax" / "data", scored / "data")
        shutil.copytree(base / "jax" / BOOT, scored / BOOT)
        for rep in range(REPS):
            (scored / _model_dir(variant) / f"{rep:03d}"
             / "deviation_3modalities.csv").unlink(missing_ok=True)
        bootstrap.test(_port_args("test", extra), project_root=scored,
                       eps_fn=jax_score_eps)
        out[variant] = {"port": port, "scored": scored}
    # the analysis of the JAX test stage's CSVs, for both variants
    analysed = base / "analysed"
    shutil.copytree(base / "jax" / BOOT, analysed / BOOT)
    out["report"] = {}
    for variant, extra in VARIANTS.items():
        out["report"][variant] = bootstrap.analyze(
            _port_args("analyze", extra), project_root=analysed)
        shutil.copy(analysed / "bootstrap_auc.csv",
                    analysed / f"bootstrap_auc_{variant}.csv")
    out["analysed"] = analysed
    return out


def test_id_files_are_the_jax_cli_bytes(runs):
    jax_dir = runs["base"] / "jax" / BOOT
    for variant in VARIANTS:
        port_dir = runs[variant]["port"] / BOOT
        names = sorted(p.name for p in port_dir.glob("*_ids_*.csv"))
        assert names == sorted(p.name for p in jax_dir.glob("*_ids_*.csv"))
        assert len(names) == 2 * REPS
        for name in names:
            assert (port_dir / name).read_bytes() == \
                (jax_dir / name).read_bytes()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("rep", range(REPS))
def test_replicate_checkpoints_match_jax(runs, variant, rep):
    rel = f"{_model_dir(variant)}/{rep:03d}"
    ref, ref_config = read_flax_checkpoint(runs["base"] / "jax" / rel)
    got, config = read_flax_checkpoint(runs[variant]["port"] / rel)
    assert config == ref_config
    assert config["c_dim"] == (1 if variant == "vae" else 29)
    assert config["unconditioned"] is (variant == "vae")
    leaves = jax.tree_util.tree_leaves
    assert len(leaves(got)) == len(leaves(ref))
    for a, b in zip(leaves(got), leaves(ref)):
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=1e-5)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("rep", range(REPS))
def test_deviation_csvs_match_jax(runs, variant, rep):
    rel = f"{_model_dir(variant)}/{rep:03d}/deviation_3modalities.csv"
    ref = pd.read_csv(runs["base"] / "jax" / rel)
    got = pd.read_csv(runs[variant]["scored"] / rel)
    assert list(got.columns) == ["participant_id", "DIA", "AGE", "PTGENDER",
                                 "Reconstruction deviation"]
    pd.testing.assert_frame_equal(got.iloc[:, :4], ref.iloc[:, :4])
    np.testing.assert_allclose(got["Reconstruction deviation"],
                               ref["Reconstruction deviation"],
                               rtol=1e-4, atol=1e-5)


def test_analysis_writes_the_jax_files(runs):
    """On the JAX test stage's CSVs: the same report lines (both variants,
    appended in turn) and the same bootstrap_auc.csv bytes."""
    jax_root, analysed = runs["base"] / "jax", runs["analysed"]
    assert ((analysed / "result_baseline" / "result_bootstrap.txt").read_text()
            == (jax_root / "result_baseline" / "result_bootstrap.txt")
            .read_text())
    # the JAX chain's last analysis was the unconditioned one
    assert ((analysed / "bootstrap_auc_vae.csv").read_bytes()
            == (jax_root / "bootstrap_auc.csv").read_bytes())
    for variant in VARIANTS:
        result = runs["report"][variant]
        assert list(result) == ["2vs0"]
        assert result["2vs0"]["n_replicates"] == REPS
        assert 0.0 <= result["2vs0"]["ci_low"] <= result["2vs0"]["ci_high"]


def test_port_chain_scores_and_reports(runs):
    """The port's own chain, scored on its own draws: finite deviations
    for every replicate's out-of-bag rows, and a report block."""
    port = runs["cvae"]["port"]
    bootstrap.test(_port_args("test"), project_root=port)
    results = bootstrap.analyze(_port_args("analyze"), project_root=port)
    for rep in range(REPS):
        test_ids = pd.read_csv(port / BOOT / f"test_ids_{rep:03d}.csv")
        dev = pd.read_csv(port / _model_dir("cvae") / f"{rep:03d}"
                          / "deviation_3modalities.csv")
        assert len(dev) == len(test_ids)
        assert np.isfinite(dev["Reconstruction deviation"]).all()
    assert results["2vs0"]["n_replicates"] == REPS
    text = (port / "result_baseline" / "result_bootstrap.txt").read_text()
    assert text.startswith("Bootstrap settings: CVAE. ADNI -D 3modalities "
                           "Epochs 2 Replicates 3 hz_para_list: [16, 16, 4]")


def _single_class_project(root, module):
    """tests/test_bootstrap.py:130-158: three replicates' deviation CSVs,
    the second holding one class only."""
    boot_dir = root / BOOT
    model_dir = boot_dir / "supervised_cvae"
    rng = np.random.default_rng(0)
    for b in range(3):
        boot_dir.mkdir(parents=True, exist_ok=True)
        pd.DataFrame({"IID": [f"s{i}" for i in range(5)]}).to_csv(
            boot_dir / f"train_ids_{b:03d}.csv", index=False)
        rep = model_dir / f"{b:03d}"
        rep.mkdir(parents=True, exist_ok=True)
        dia = [2] * 6 if b == 1 else [2, 2, 2, 0, 0, 0]
        dev = (np.where(np.asarray(dia) == 0, 5.0, 1.0)
               + rng.normal(scale=0.01, size=6))
        pd.DataFrame({
            "participant_id": [f"s{i}" for i in range(6)], "DIA": dia,
            "AGE": 70, "PTGENDER": 1, "Reconstruction deviation": dev,
        }).to_csv(rep / "deviation_3modalities.csv", index=False)
    module.analyze(_args("analyze", module.build_parser()),
                   project_root=root)
    return pd.read_csv(root / "bootstrap_auc.csv")


def test_analyze_skips_a_single_class_replicate_without_shifting(tmp_path):
    got = _single_class_project(tmp_path / "port", bootstrap)
    assert sorted(got["replicate"]) == [0, 2]
    assert (got["auc"] == 1.0).all()
    ref = _single_class_project(tmp_path / "jax", jax_boot)
    assert ((tmp_path / "port" / "bootstrap_auc.csv").read_bytes()
            == (tmp_path / "jax" / "bootstrap_auc.csv").read_bytes())
    pd.testing.assert_frame_equal(got, ref)


def test_create_ids_removes_stale_files_like_jax(tmp_path):
    for name, module in (("jax", jax_boot), ("port", bootstrap)):
        root = tmp_path / name
        make_synthetic_resource(root, "ADNI", n_hc=30, n_disease={0: 10})
        parser = module.build_parser()
        module.create_ids(_args("create_ids", parser, ["-B", "5"]),
                          project_root=root)
        module.create_ids(_args("create_ids", parser, ["-B", "2", "-O",
                                                       "0.8"]),
                          project_root=root)
    names = sorted(p.name for p in (tmp_path / "port" / BOOT).iterdir())
    assert names == ["test_ids_000.csv", "test_ids_001.csv",
                     "train_ids_000.csv", "train_ids_001.csv"]
    for name in names:
        assert ((tmp_path / "port" / BOOT / name).read_bytes()
                == (tmp_path / "jax" / BOOT / name).read_bytes())
    assert len(pd.read_csv(tmp_path / "port" / BOOT
                           / "train_ids_000.csv")) == 24


def test_early_fusion_csv_and_in_memory_fusion_agree(tmp_path):
    """-D 3modalities reads early_fusion_modalities_ADNI.csv when it is
    there and fuses the base modalities in memory when it is not: the same
    train data up to the CSV's round trip, the same test frames."""
    roots = {}
    for mode in ("file", "mem"):
        root = tmp_path / mode
        make_synthetic_resource(root, "ADNI", n_hc=30, n_disease={0: 10},
                                with_early_fusion=(mode == "file"), seed=4)
        bootstrap.create_ids(_port_args("create_ids"), project_root=root)
        roots[mode] = root
    preps = {}
    for mode, root in roots.items():
        boot_dir = root / BOOT
        preps[mode] = bootstrap._prepare_all(
            root, "ADNI", "3modalities", root / "data" / "ADNI" / "y.csv",
            [(boot_dir / f"train_ids_{b:03d}.csv",
              boot_dir / f"test_ids_{b:03d}.csv") for b in range(REPS)])
    for file_prep, mem_prep in zip(preps["file"], preps["mem"]):
        for key in ("train_data", "test_data", "train_cov", "test_cov"):
            np.testing.assert_allclose(mem_prep[key], file_prep[key],
                                       rtol=1e-5, atol=1e-8)
        assert mem_prep["train_data"].shape[1] == 270
        pd.testing.assert_frame_equal(
            mem_prep["test_df"][["participant_id", "DIA", "AGE", "PTGENDER"]],
            file_prep["test_df"][["participant_id", "DIA", "AGE",
                                  "PTGENDER"]])


def _train_copy(root, **kw):
    args = _port_args("train")
    for k, v in kw.items():
        setattr(args, k, v)
    bootstrap.train(args, project_root=root)


def test_kill_and_resume_is_byte_equal(tmp_path):
    """tests/test_bootstrap.py:182-213: a run killed after 3 epochs and
    resumed equals the straight run byte for byte; a resume over another
    replicate set is refused."""
    roots = {}
    for name in ("ref", "res"):
        root = tmp_path / name
        make_synthetic_resource(root, "ADNI", n_hc=50, n_disease={0: 20})
        bootstrap.create_ids(_port_args("create_ids"), project_root=root)
        roots[name] = root
    _train_copy(roots["ref"], epochs=6)
    _train_copy(roots["res"], epochs=3, checkpoint_every=3)
    _train_copy(roots["res"], epochs=6, checkpoint_every=3, resume=True)
    model_dir = _model_dir("cvae")
    assert train_state_exists(roots["res"] / model_dir)
    for rep in range(REPS):
        rel = f"{model_dir}/{rep:03d}/cVAE_model.ckpt"
        assert ((roots["ref"] / rel).read_bytes()
                == (roots["res"] / rel).read_bytes())
    # another replicate set: replicate 0's id files removed
    for kind in ("train", "test"):
        (roots["res"] / BOOT / f"{kind}_ids_000.csv").unlink()
    (roots["res"] / BOOT / "train_ids_003.csv").write_bytes(
        (roots["res"] / BOOT / "train_ids_001.csv").read_bytes())
    with pytest.raises(ValueError, match="refusing to resume"):
        _train_copy(roots["res"], epochs=6, checkpoint_every=3, resume=True)


def test_fold_seeds_give_each_replicate_its_stream():
    """FoldNoise with per-fold seeds draws fold f's stream from seeds[f];
    without seeds every fold draws config.seed's."""
    from multi_modal_normative_modeling_tpu_torch.train.trainer import (
        FoldNoise,
    )

    valid = np.ones(3, bool)
    alike = FoldNoise(3, (4, 2), 42, "cpu").draw(valid)
    seeded = FoldNoise(3, (4, 2), 42, "cpu", seeds=[1000, 1001, 42]).draw(
        valid)
    assert torch.equal(alike[0], alike[1]) and torch.equal(alike[0],
                                                           alike[2])
    assert torch.equal(seeded[2], alike[0])
    assert torch.equal(
        seeded[0], torch.randn((4, 2),
                               generator=torch.Generator().manual_seed(1000)))
    assert not torch.equal(seeded[0], seeded[1])
    with pytest.raises(ValueError, match="2 seeds for 3 folds"):
        FoldNoise(3, (4, 2), 42, "cpu", seeds=[1, 2])


def test_mesh_and_missing_cuda_exit_before_any_file(tmp_path, monkeypatch):
    make_synthetic_resource(tmp_path, "ADNI", n_hc=20, n_disease={0: 8})
    with pytest.raises(SystemExit, match="ROADMAP.md, queue 1 item "
                                         "'Multi-device'"):
        bootstrap.main(_port_args("all", ["--mesh", "2,2"]),
                       project_root=tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bootstrap.main(_args("all", bootstrap.build_parser()),
                       project_root=tmp_path)
    with pytest.raises(SystemExit, match="--resume requires"):
        bootstrap.main(_port_args("all", ["--resume"]),
                       project_root=tmp_path)
    assert not (tmp_path / "outputs").exists()


def test_parser_takes_the_jax_flags_and_defaults_to_cuda():
    def flags(parser):
        return {a.dest: (a.option_strings, a.default)
                for a in parser._actions}

    port, ref = flags(bootstrap.build_parser()), flags(
        jax_boot.build_parser())
    assert port.pop("device") == (["--device"], "cuda")
    assert port == ref
    args = bootstrap.build_parser().parse_args(
        ["all", "--no_fused_heads", "--unconditioned"])
    assert args.no_fused_heads and args.unconditioned
    assert args.dataset == "3modalities" and args.n_bootstrap == 10
