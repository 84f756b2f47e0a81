"""The result line, the device trace's reading, and the metric readers."""
import json
import os
import subprocess
import sys

import pytest

from perfbench import devtrace, harness, spec, work

RUN = str(spec.HERE / "run.py")


def test_without_a_gpu_a_run_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, RUN, "--workload",
                          "adni_uca_gpoe.train_fused", "--seed", "3",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=spec.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "GPU" in out.stderr


def test_without_the_program_a_run_fails(tmp_path):
    """A directory holding only BENCHMARK.json and perfbench/."""
    import shutil

    shutil.copytree(spec.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "adni_uca_gpoe.train_fused", "--seed", "3",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("cell", ["adni_uca_gpoe.train_fused",
                                  "ppmi_se_gpoe.train_fused"])
def test_the_result_line(small, cell):
    result = harness.run_cell(cell, 2**31 + 99, 0.2, False, "cpu",
                              **small(cell))
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] >= 1 and line["failed"] == 0
    bench = spec.load_benchmark()
    want = {m["name"]: m["unit"] for m in spec.metrics_of(bench, cell, False)}
    assert {k: v["unit"] for k, v in line["metrics"].items()} == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"}


def trace_events():
    """A window of 100 us on one thread: two kernels (10-30, 25-40) and a
    copy (70-80) on the device; the host in perfbench.run, in aten::mm
    (5-45) and aten::sum (50-95)."""
    host = {"pid": 1, "tid": 7, "ph": "X"}
    dev = {"pid": 0, "tid": 9, "ph": "X"}
    return [
        dict(host, cat="user_annotation", name=devtrace.WINDOW, ts=0,
             dur=100),
        dict(host, cat="user_annotation", name="perfbench.run", ts=1,
             dur=98),
        dict(host, cat="cpu_op", name="aten::mm", ts=5, dur=40),
        dict(host, cat="cpu_op", name="aten::sum", ts=50, dur=45),
        dict(host, tid=8, cat="cpu_op", name="other thread", ts=0, dur=100),
        dict(dev, cat="kernel", name="k1", ts=10, dur=20),
        dict(dev, cat="kernel", name="k2", ts=25, dur=15),
        dict(dev, cat="gpu_memcpy", name="copy", ts=70, dur=10),
        dict(dev, cat="gpu_user_annotation", name="perfbench.run", ts=0,
             dur=100),
        dict(dev, cat="kernel", name="outside", ts=150, dur=10),
    ]


def test_the_trace_reading():
    trace = devtrace.Trace(trace_events())
    assert trace.kernels == 2
    assert trace.window_s == pytest.approx(100e-6)
    assert trace.busy_s == pytest.approx(40e-6)       # 10-40 and 70-80
    assert trace.device_ops() == [["k1", pytest.approx(20e-6)],
                                  ["k2", pytest.approx(15e-6)],
                                  ["copy", pytest.approx(10e-6)]]
    gaps = dict(trace.idle_gaps())
    # the gaps' middles: 0-10's (5) in aten::mm, 40-70's (55) and
    # 80-100's (90) in aten::sum
    assert gaps == {"perfbench.run: aten::mm": pytest.approx(10e-6),
                    "perfbench.run: aten::sum": pytest.approx(50e-6)}


def test_the_per_layer_readers():
    cfg = spec.config(spec.load_benchmark(), "adni_uca_gpoe")
    trace = devtrace.Trace(trace_events())
    win = harness.Window(attempted=10, elapsed_s=2.0, units=1000,
                         samples=1)
    ctx = harness.Context("adni_uca_gpoe.train_fused", 5.0, win,
                          work.train_step(cfg),
                          work.train_step_model_flops(cfg), trace, 4)
    read = {m: spec.reader(m)(ctx) for m in (
        "launches_per_step.train", "roofline_pct.train",
        "device_idle_pct.train", "mfu.train", "setup_s",
        "train_samples_per_s")}
    assert read["launches_per_step.train"] == 0.5
    assert read["roofline_pct.train"] == pytest.approx(
        100 * 4 * work.train_step(cfg).bound_s / 40e-6)
    assert read["device_idle_pct.train"] == pytest.approx(60.0)
    assert read["mfu.train"] == pytest.approx(
        100 * 1000 * work.train_step_model_flops(cfg) / (2.0 * 67e12))
    assert read["setup_s"] == 5.0
    assert read["train_samples_per_s"] == 0.5
    ctx.trace = None
    assert spec.reader("roofline_pct.train")(ctx) is None


def test_a_reader_is_found_by_its_full_name_then_its_base():
    assert spec.reader_path("setup_s").name == "setup_s.py"
    assert spec.reader_path("mfu.train").name == "mfu.py"
    assert spec.reader_path("mfu.anything").name == "mfu.py"
    with pytest.raises(FileNotFoundError):
        spec.reader_path("no_such_metric.train")


def test_a_reader_that_finds_nothing_is_named_and_left_out(capsys):
    entries = [{"name": "roofline_pct.train", "unit": "%"},
               {"name": "setup_s", "unit": "s"}]
    ctx = harness.Context("x", 5.0, harness.Window(), None, 0.0)
    assert spec.read_metrics(entries, ctx) == {
        "setup_s": {"value": 5.0, "unit": "s"}}
    assert "roofline_pct.train found nothing" in capsys.readouterr().err
