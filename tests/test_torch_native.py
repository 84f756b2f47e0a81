"""The port's native data plane (native/) against the JAX package's.

The port keeps its own copy of native/: the C++ sources byte for byte, the
ctypes wrappers with the build directory moved into the port. Its read path
(``cli/common.read_csv``) must give the frames and the disengage reasons of
the JAX package's ``read_csv_cached`` on the wide, narrow, quoted, NaN and
malformed cases of tests/test_native.py, and ``infer/emitters.write_csv``
the bytes of ``DataFrame.to_csv`` and of the JAX package's ``write_csv``.
Runs on the CPU with g++ (no GPU needed)."""
import inspect
import logging

import numpy as np
import pandas as pd
import pytest

from multi_modal_normative_modeling_tpu import native as jax_native
from multi_modal_normative_modeling_tpu.cli import common as jax_common
from multi_modal_normative_modeling_tpu.infer import emitters as jax_emitters
from multi_modal_normative_modeling_tpu.native import (
    fastcsv as jax_fastcsv,
    fastwrite as jax_fastwrite,
)
from multi_modal_normative_modeling_tpu_torch import native
from multi_modal_normative_modeling_tpu_torch.cli import common
from multi_modal_normative_modeling_tpu_torch.infer import emitters
from multi_modal_normative_modeling_tpu_torch.native import (
    _build,
    fastcsv,
    fastwrite,
)


@pytest.mark.parametrize("name", ["fastcsv.cpp", "fastwrite.cpp"])
def test_sources_are_byte_copies(name):
    port = _build.BUILD_DIR.parent / name
    ref = jax_native.__file__.replace("__init__.py", name)
    assert port.read_bytes() == open(ref, "rb").read()


@pytest.mark.parametrize("module,ref,names", [
    (fastcsv, jax_fastcsv, ["_configure", "_lib", "fastcsv_available",
                            "FastCSV", "read_feature_matrix"]),
    (fastwrite, jax_fastwrite, ["_configure", "_lib", "fastwrite_available",
                                "write_frame"]),
], ids=["fastcsv", "fastwrite"])
def test_wrappers_are_the_jax_wrappers(module, ref, names):
    for name in names:
        assert inspect.getsource(getattr(module, name)) == \
            inspect.getsource(getattr(ref, name)), name


def test_libraries_build_into_the_port():
    assert fastcsv.fastcsv_available() and fastwrite.fastwrite_available()
    assert _build.BUILD_DIR.name == "_build"
    assert _build.BUILD_DIR.parent.name == "native"
    built = sorted(p.name.split("_")[0] for p in
                   _build.BUILD_DIR.glob("lib*_*.so"))
    assert {"libfastcsv", "libfastwrite"} <= set(built)
    assert _build.GXX_FLAGS == ("-O3", "-std=c++17", "-shared", "-fPIC",
                                "-pthread")


def _wide(rng, n=20, d=300):
    frame = pd.DataFrame(rng.normal(size=(n, d)),
                         columns=[f"c{i}" for i in range(d)])
    frame.insert(0, "IID", [f"s{i}" for i in range(n)])
    return frame


def _case(name, path, rng):
    """The file of one read case; returns whether the native path takes
    it."""
    if name == "wide":
        _wide(rng).to_csv(path, index=False)
        return True
    if name == "narrow":
        _wide(rng, d=40).to_csv(path, index=False)
        return False
    if name == "nan":
        frame = _wide(rng)
        frame.loc[3, "c7"] = np.nan
        frame.to_csv(path, index=False)
        return False
    if name == "embedded_newline":
        frame = _wide(rng, n=12)
        frame.loc[4, "IID"] = "s\n4"
        frame.to_csv(path, index=False)
        return False
    if name == "quoted":
        header = '"IID",' + ",".join(f'"c{i}"' for i in range(300))
        rows = [f'"s{r}",' + ",".join(f'"{v!r}"' if i % 7 == 0 else repr(v)
                                      for i, v in enumerate(
                                          rng.normal(size=300).tolist()))
                for r in range(6)]
        path.write_text("\n".join([header] + rows) + "\n")
        return True
    if name == "malformed":
        # a row short of cells: the native parse refuses, pandas reads NaN
        frame = _wide(rng, n=5)
        text = frame.to_csv(index=False).splitlines()
        text[2] = ",".join(text[2].split(",")[:-3])
        path.write_text("\n".join(text) + "\n")
        return False
    if name == "no_iid":
        frame = _wide(rng).rename(columns={"IID": "ID"})
        frame.to_csv(path, index=False)
        return False
    raise ValueError(name)


READ_CASES = ["wide", "narrow", "nan", "embedded_newline", "quoted",
              "malformed", "no_iid"]


@pytest.mark.parametrize("case", READ_CASES)
def test_read_csv_is_the_jax_read(tmp_path, case, caplog):
    path = tmp_path / f"{case}.csv"
    native_path = _case(case, path, np.random.default_rng(7))
    with caplog.at_level(logging.DEBUG, logger="mmnm.data"):
        got = common.read_csv(path)
        ref = jax_common.read_csv_cached(path)
    pd.testing.assert_frame_equal(got, ref)
    assert common.fast_path_reasons.get(str(path)) == \
        jax_common.fast_path_reasons.get(str(path))
    assert (str(path) not in common.fast_path_reasons) == (
        native_path or case == "no_iid")
    if native_path:
        # correctly rounded: pandas' round-trip parser gives the same values
        np.testing.assert_array_equal(
            got.drop(columns="IID").to_numpy(),
            pd.read_csv(path, float_precision="round_trip")
            .drop(columns="IID").to_numpy())
    common.fast_path_reasons.pop(str(path), None)
    jax_common.fast_path_reasons.pop(str(path), None)


def test_disengaged_reason_is_memoized_until_the_file_changes(tmp_path,
                                                              caplog):
    import os

    rng = np.random.default_rng(2)
    frame = _wide(rng)
    dirty = frame.copy()
    dirty.loc[2, "c5"] = np.nan
    path = tmp_path / "rewrite.csv"
    dirty.to_csv(path, index=False)
    with caplog.at_level(logging.INFO, logger="mmnm.data"):
        common.read_csv(path)
        common.read_csv(path)
    msgs = [r.message for r in caplog.records
            if "fast path disabled" in r.message]
    assert len(msgs) == 1 and "missing cells" in msgs[0]
    frame.to_csv(path, index=False)
    os.utime(path, ns=(path.stat().st_atime_ns,
                       path.stat().st_mtime_ns + 10_000_000))
    out = common.read_csv(path)
    assert str(path) not in common.fast_path_reasons
    np.testing.assert_allclose(out[frame.columns[1:]].values,
                               frame[frame.columns[1:]].values, rtol=1e-15)


def test_a_modality_table_of_a_cohort_reads_natively(tmp_path):
    """The wide synthetic PPMI table goes through the native loader; its
    scaled values equal the round-trip parser's (the port's read path
    before the native loader), so no value moves."""
    from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
        make_synthetic_resource,
    )

    data_dir = make_synthetic_resource(
        tmp_path, "PPMI", n_hc=20, n_disease={0: 10},
        modalities=["PPMI_new_modal1_upper_tri"])
    path = data_dir / "PPMI_new_modal1_upper_tri.csv"
    got = common.read_csv(path)
    assert str(path) not in common.fast_path_reasons
    ref = pd.read_csv(path, float_precision="round_trip")
    assert list(got.columns) == list(ref.columns)
    assert list(got["IID"]) == list(ref["IID"].astype(str))
    np.testing.assert_array_equal(got.drop(columns="IID").to_numpy(),
                                  ref.drop(columns="IID").to_numpy())
    assert common.read_csv(data_dir / "y.csv").equals(
        pd.read_csv(data_dir / "y.csv"))


def _write_cases(rng):
    n = 500
    values = np.concatenate([
        rng.normal(size=n - 12),
        np.array([0.0, -0.0, 1e16, 1e15, 1e-4, 1e-5, 2.5e-4, 2.0, np.nan,
                  5e-324, 0.001, 123456789.0])])
    yield "emitter", pd.DataFrame({
        "participant_id": [f"s{i}" for i in range(n)],
        "DIA": rng.integers(0, 3, size=n).astype(np.int64),
        "f64": values, "f32": values.astype(np.float32)})
    f64 = np.array([1e100, -1e100, 1e-100, 1.7976931348623157e308,
                    2.2250738585072014e-308, -4.9e-324, np.inf, -np.inf,
                    9.999999999999999e15, 1.0000000000000002,
                    3.141592653589793e-5, -0.0001, 12345.6789e90])
    f32 = np.array([3.4028235e38, 1.1754944e-38, 1e-45, -6.1e-5, 9.9e-5,
                    1.00001e-4, np.inf, -np.inf, 16777216.0, 1.5e-7,
                    7.0e37, -2.802597e-45, 0.0], dtype=np.float32)
    yield "exponents", pd.DataFrame({"id": [f"s{i}" for i in range(13)],
                                     "f64": f64, "f32": f32})
    yield "quoting", pd.DataFrame({"s": ["a,b", "c"], "v": [1.0, 2.0]})
    yield "header_comma", pd.DataFrame({"a,x": [1.0, 2.0], "b": [3.0, 4.0]})
    yield "nul", pd.DataFrame({"s": ["a\x00b", "cd"], "v": [1.0, 2.0]})
    yield "bool", pd.DataFrame({"s": ["a", "b"], "v": [True, False]})


WRITE_CASES = {name: frame
               for name, frame in _write_cases(np.random.default_rng(0))}
NATIVE_WRITES = {"emitter", "exponents"}


@pytest.mark.parametrize("case", sorted(WRITE_CASES))
def test_write_csv_is_to_csv_and_the_jax_writer(tmp_path, case):
    frame = WRITE_CASES[case]
    frame.to_csv(tmp_path / "ref.csv", index=False)
    emitters.write_csv(tmp_path / "port.csv", frame)
    jax_emitters.write_csv(tmp_path / "jax.csv", frame)
    ref = (tmp_path / "ref.csv").read_bytes()
    assert (tmp_path / "port.csv").read_bytes() == ref
    assert (tmp_path / "jax.csv").read_bytes() == ref
    # the native writer took the frame, or it handed it back to pandas
    assert fastwrite.write_frame(tmp_path / "native.csv", frame) is (
        case in NATIVE_WRITES)


def test_fastcsv_parses_like_pandas(tmp_path):
    """tests/test_native.py's reader cases on the port's module: quoted
    fields, CRLF, blank lines, a header-only file."""
    path = tmp_path / "quoted.csv"
    path.write_text('"IID","a,x",b,"no""te"\n'
                    '"s,1","1.5",2,"he,""llo"""\n'
                    's2,-3,"4e-2",plain\n')
    ref = pd.read_csv(path)
    reader = native.FastCSV(path)
    try:
        assert reader.read_string_column("IID") == list(ref["IID"])
        assert reader.read_string_column('no"te') == ['he,"llo"', "plain"]
        np.testing.assert_allclose(reader.read_columns(["a,x", "b"]),
                                   ref[["a,x", "b"]].values)
    finally:
        reader.close()
    path = tmp_path / "blank.csv"
    path.write_bytes(b"IID,a,b\r\ns1,1,2\r\n\r\ns2,3,4\r\n\n\n")
    ids, values = native.read_feature_matrix(path, ["a", "b"])
    assert ids == ["s1", "s2"]
    np.testing.assert_array_equal(values, [[1.0, 2.0], [3.0, 4.0]])
    path = tmp_path / "empty.csv"
    path.write_text("IID," + ",".join(f"c{i}" for i in range(300)))
    reader = native.FastCSV(path)
    try:
        assert (reader.n_rows, reader.n_cols) == (0, 301)
    finally:
        reader.close()
