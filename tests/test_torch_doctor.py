"""The port's environment doctor (cli/doctor.py), on the CPU.

The JAX doctor's ``--json`` schema (a list of {section, status, detail})
and OK / WARN / FAIL lines; the port's sections (versions, device,
kernel-build, native-fastcsv, native-fastwrite, project). Here, with no
card, ``device`` is a FAIL and the exit code 1; the project texts equal
the JAX doctor's on the trees of tests/test_doctor.py:67-95; the flag set
is the JAX doctor's; ``--mesh-check`` / ``--ep-check`` exit citing
ROADMAP.md's 'Multi-device'. tests/test_torch_cuda.py holds the exit 0 on
the card.
"""
import json

import pytest

from multi_modal_normative_modeling_tpu.cli import doctor as jax_doctor
from multi_modal_normative_modeling_tpu_torch.cli import doctor

SECTIONS = ["versions", "device", "kernel-build", "native-fastcsv",
            "native-fastwrite"]


def _run(argv, capsys):
    rc = doctor.run(argv)
    return rc, capsys.readouterr().out


def test_json_schema_sections_and_exit_without_a_card(capsys):
    rc, out = _run(["--json"], capsys)
    results = json.loads(out)
    assert [r["section"] for r in results] == SECTIONS
    assert all(set(r) == {"section", "status", "detail"} for r in results)
    status = {r["section"]: r["status"] for r in results}
    assert set(status.values()) <= {"OK", "WARN", "FAIL"}
    assert status["versions"] == "OK"
    assert status["device"] == "FAIL"
    assert rc == 1
    detail = {r["section"]: r["detail"] for r in results}
    assert "torch" in detail["versions"] and "msgpack" in detail["versions"]
    assert "no CUDA device is available" in detail["device"]
    assert "sm_90a" in detail["kernel-build"]


def test_human_output(capsys):
    rc, out = _run([], capsys)
    assert rc == 1
    lines = out.splitlines()
    assert len(lines) == len(SECTIONS)
    assert lines[0].startswith("[OK  ] versions")
    assert any(line.startswith("[FAIL] device") for line in lines)


def test_kernel_build_check(monkeypatch):
    """No nvcc is a FAIL; nvcc without a card a WARN naming its release
    and the target; a build that raises a FAIL."""
    results = []
    monkeypatch.setattr(doctor, "_nvcc_release", lambda nvcc: None)
    doctor.check_kernel_build(results, card=False)
    assert results[-1]["status"] == "FAIL"
    assert "nvcc not found" in results[-1]["detail"]
    monkeypatch.setattr(doctor, "_nvcc_release",
                        lambda nvcc: "release 12.9, V12.9.86")
    doctor.check_kernel_build(results, card=False)
    assert results[-1]["status"] == "WARN"
    assert "release 12.9" in results[-1]["detail"]
    assert "target sm_90a" in results[-1]["detail"]

    def failing():
        raise RuntimeError("nvcc failed (2)")

    from multi_modal_normative_modeling_tpu_torch.kernels import _build
    monkeypatch.setattr(_build, "load_library", failing)
    doctor.check_kernel_build(results, card=True)
    assert results[-1]["status"] == "FAIL"
    assert "nvcc failed (2)" in results[-1]["detail"]


def _tree(tmp_path, kind):
    if kind == "good":
        good = tmp_path / "data" / "ADNI"
        good.mkdir(parents=True)
        (good / "y.csv").write_text("IID,Diagnosis\n1,1\n")
        (good / "av45.csv").write_text("IID,a\n1,0.5\n")
    elif kind == "missing_y":
        bad = tmp_path / "data" / "PPMI"
        bad.mkdir(parents=True)
        (bad / "dti.csv").write_text("IID,a\n1,0.5\n")
    elif kind == "empty":
        (tmp_path / "data").mkdir()
    return tmp_path


@pytest.mark.parametrize("kind", ["good", "missing_y", "empty", "no_data"])
def test_project_texts_equal_the_jax_doctor(kind, tmp_path, capsys):
    root = _tree(tmp_path, kind)
    got, want = [], []
    doctor.check_project(got, root)
    jax_doctor.check_project(want, root)
    assert got == want
    rc, out = _run(["--json", "--root", str(root)], capsys)
    assert [r for r in json.loads(out) if r["section"] == "project"] == want


def test_flag_set_equals_the_jax_doctor():
    def flags(parser):
        return sorted(opt for action in parser._actions
                      for opt in action.option_strings)

    assert flags(doctor.build_parser()) == flags(jax_doctor.build_parser())


# the preflights are ported (tests/test_torch_mesh_serving.py runs their
# child steps on CPU ranks): a geometry whose gate fails reports FAIL with
# the JAX doctor's text before any child starts
@pytest.mark.parametrize("argv,detail", [
    (["--mesh-check", "0,2"], "--mesh-check '0,2': expected comma-separated "
                              "positive axis sizes, e.g. 2,4 or 2,2,2"),
    (["--ep-check", "3,2", "--ep-modalities", "4"],
     "ep mesh 3,2: 4 modalities not divisible over the 3-way 'modality' "
     "mesh axis")])
def test_preflights_exit_citing_multi_device(argv, detail, capsys):
    rc, out = _run(argv + ["--json"], capsys)
    found = [r for r in json.loads(out)
             if r["section"] in ("mesh-check", "ep-check")]
    assert rc == 1
    assert found == [{"section": found[0]["section"], "status": "FAIL",
                      "detail": detail}]


def test_attach_flags_are_accepted_with_no_effect(capsys):
    rc, out = _run(["--json", "--no-attach", "--attach-timeout", "0.01"],
                   capsys)
    assert [r["section"] for r in json.loads(out)] == SECTIONS
