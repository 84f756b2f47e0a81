"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's),
and the reference loads nothing of the port."""
import ast
import subprocess
import sys
import textwrap

import pytest

from perfbench import harness, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "optax",
             "multi_modal_normative_modeling_tpu"}
PORT = "multi_modal_normative_modeling_tpu_torch"


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def sources():
    return sorted(p for p in spec.HERE.rglob("*.py")
                  if "tests" not in p.relative_to(spec.HERE).parts)


def test_no_source_imports_jax_by_whole_name():
    for path in sources():
        tops = {name.split(".")[0] for name in imported(path)}
        assert not tops & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_port():
    for path in (spec.HERE / "reference").rglob("*.py"):
        tops = {name.split(".")[0] for name in imported(path)}
        assert PORT not in tops, path
        assert tops <= {"__future__", "contextlib", "math", "typing",
                        "torch"}, (path, tops)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    before = harness.forbidden_modules()
    for name in ("multi_modal_normative_modeling_tpu_torch.train",
                 "jaxtyping", "flax_like", "optaxis"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "multi_modal_normative_modeling_tpu",
                        object())
    assert "multi_modal_normative_modeling_tpu" in harness.forbidden_modules()


@pytest.mark.parametrize("cell", ["adni_uca_gpoe.train_fused",
                                  "ppmi_se_gpoe.train_fused"])
def test_a_run_loads_no_jax(cell):
    """A whole run (small shapes, on the CPU) in a fresh process: the
    modules loaded by its end include the port and none of JAX's."""
    code = textwrap.dedent(f'''
        import sys
        sys.path.insert(0, {str(spec.ROOT)!r})
        sys.path.insert(0, {str(spec.HERE / "tests")!r})
        from conftest import small_cell
        from perfbench import harness
        r = harness.run_cell({cell!r}, 3, 0.2, False, "cpu",
                             **small_cell({cell!r}))
        assert r["correct"], r
        assert {PORT!r} in sys.modules
        print(harness.forbidden_modules())
        ''')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
