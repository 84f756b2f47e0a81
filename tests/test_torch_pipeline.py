"""The port's test stage end to end against the JAX package's.

A small UCA-gPoE cohort is trained by the JAX trainer; the JAX test stage
and the port's test stage (device cpu, the plain versions of the kernels)
then score copies of the same project with the same checkpoints and the
same eps (the JAX stream PRNGKey(1000 + fold), replayed through ``eps_fn``).
The port must write the same files with the same columns: normalized_* CSVs
byte-equal (both packages scale the same float64 data), the rest within
rtol 1e-4 / atol 1e-5 (float32 model math in another order). JAX group
analysis then runs on the port's CSVs."""
import argparse
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from multi_modal_normative_modeling_tpu.cli import (
    group_analysis,
    test_supervised as jax_test,
    train_supervised,
)
from multi_modal_normative_modeling_tpu.data.synthetic import (
    make_synthetic_resource,
)
from multi_modal_normative_modeling_tpu_torch.cli import (
    test_supervised as port_test,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def _args(**extra):
    return argparse.Namespace(
        dataset_resourse="ADNI", hz_para_list=[16, 16, 6],
        procedure="UCA-gPoE", combine="gPoE", epochs=3, n_splits=2,
        oversample_percentage=1, model="cVAE_multimodal",
        single_modality=None, base_learning_rate=0.0001,
        max_learning_rate=0.005, training_class="nm",
        lr_schedule="constant", fold_parallel=True, precision="fp32",
        **extra)


def _jax_eps(fold, padded_rows, z_dim):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(1000 + fold),
                                        (padded_rows, z_dim)))


def _test_outputs(root: Path):
    """Relative paths of the CSVs the test stage writes."""
    out = {p.relative_to(root) for p in (root / "deviation").rglob("*.csv")}
    model_dir = root / "outputs" / "kfold_analysis" / "supervised_cvae"
    out |= {p.relative_to(root) for p in model_dir.glob("*/*/*.csv")}
    return out


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    jax_root = tmp_path_factory.mktemp("jax_stage")
    make_synthetic_resource(jax_root, "ADNI", n_hc=40,
                            n_disease={0: 16, 1: 16}, with_early_fusion=True)
    train_supervised.main(_args(), project_root=jax_root)
    port_root = tmp_path_factory.mktemp("port_stage") / "project"
    shutil.copytree(jax_root, port_root)
    jax_test.main(_args(), project_root=jax_root)
    port_test.main(_args(device="cpu"), project_root=port_root,
                   eps_fn=_jax_eps)
    return jax_root, port_root


def test_port_writes_the_jax_files(scored):
    jax_root, port_root = scored
    jax_files = _test_outputs(jax_root)
    assert len(jax_files) == 2 * 4 * 5 + 4 * 5
    assert _test_outputs(port_root) == jax_files


def test_port_csvs_match_jax(scored):
    jax_root, port_root = scored
    for rel in sorted(_test_outputs(jax_root)):
        if rel.name.startswith("normalized_"):
            assert (port_root / rel).read_bytes() == \
                (jax_root / rel).read_bytes(), rel
            continue
        ref = pd.read_csv(jax_root / rel)
        got = pd.read_csv(port_root / rel)
        assert list(got.columns) == list(ref.columns), rel
        assert got.shape == ref.shape, rel
        numeric = ref.select_dtypes("number").columns
        other = [c for c in ref.columns if c not in set(numeric)]
        pd.testing.assert_frame_equal(got[other], ref[other])
        np.testing.assert_allclose(got[numeric].to_numpy(np.float64),
                                   ref[numeric].to_numpy(np.float64),
                                   rtol=1e-4, atol=1e-5, err_msg=str(rel))


def test_group_analysis_runs_on_port_csvs(scored):
    _, port_root = scored
    stats = group_analysis.main(_args(), project_root=port_root)
    assert len(stats["auc"]) > 0
    assert np.isfinite(stats["auc"]).all()


def test_core_imports_no_jax_flax_pandas_msgpack():
    code = (
        "import sys\n"
        "import multi_modal_normative_modeling_tpu_torch.models\n"
        "import multi_modal_normative_modeling_tpu_torch.kernels\n"
        "import multi_modal_normative_modeling_tpu_torch.parallel\n"
        "import multi_modal_normative_modeling_tpu_torch.interop\n"
        "bad = [m for m in ('jax', 'flax', 'pandas', 'msgpack')\n"
        "       if m in sys.modules]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_never_imports_jax():
    """No module of the port names jax or flax."""
    package = REPO / "multi_modal_normative_modeling_tpu_torch"
    for path in package.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                assert not any(w.split(".")[0] in ("jax", "flax")
                               for w in words[1:]), f"{path}: {line}"


def test_cuda_device_required_by_default(monkeypatch):
    """--device cuda (the default) exits with an error on a machine without
    a CUDA device, instead of falling back to the CPU."""
    assert port_test.build_parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_test.resolve_device("cuda")
    assert port_test.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("flag,value", [("mesh", "2,4"), ("ep_mesh", "4,2"),
                                        ("in_memory_fusion", True),
                                        ("emit_latent", True)])
def test_unported_flags_raise(flag, value, tmp_path, scored):
    args = _args(device="cpu", **{flag: value})
    if flag == "in_memory_fusion":
        # ported: the same checkpoints scored with the early-fusion modality
        # built in memory, its CSV deleted, match the file-based CSVs at
        # tests/test_uca_pipeline.py:77-79's bound
        _, port_root = scored
        root = tmp_path / "project"
        shutil.copytree(port_root, root)
        fused = "early_fusion_modalities_ADNI"
        (root / "data" / "ADNI" / f"{fused}.csv").unlink()
        port_test.main(args, project_root=root, eps_fn=_jax_eps)
        rel = (Path("deviation/supervised_cvae/ADNI/UCA-gPoE/path_model")
               / fused / f"reconstruction_error_{fused}.csv")
        got, ref = pd.read_csv(root / rel), pd.read_csv(port_root / rel)
        assert list(got.columns) == list(ref.columns)
        np.testing.assert_allclose(got["Reconstruction error"],
                                   ref["Reconstruction error"], rtol=1e-5,
                                   atol=1e-8)
        return
    if flag == "emit_latent":
        # the flag is ported: it passes the gate and the stage goes on to
        # read the project, which this empty directory does not hold
        with pytest.raises(FileNotFoundError):
            port_test.main(args, project_root=tmp_path)
        return
    # --mesh and --ep_mesh are ported: 8 slots in a world of one rank are
    # refused with the JAX message (tests/test_torch_mesh_cli.py and
    # tests/test_torch_ep_cli.py run the meshed stages)
    match = ("8 mesh slots != 1 visible devices"
             if flag in ("mesh", "ep_mesh") else "ROADMAP.md")
    with pytest.raises(SystemExit, match=match):
        port_test.main(args, project_root=tmp_path)
