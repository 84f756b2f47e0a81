"""BENCHMARK.json against the rules its file keeps to, and everything of a
cell found by name: a new configuration, mix, cell and metric are new
files and entries, and no file is edited."""
import json
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from perfbench import spec

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_benchmark()


def one_line(text, most=200):
    return (isinstance(text, str) and 1 <= len(text) <= most
            and "\n" not in text and "\t" not in text)


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_in_the_charset(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith("perfbench/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not re.search(r"(_dim|_rank|hidden|latent|width)", key)


def test_workloads():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and one_line(w["why"])
        assert (spec.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (spec.HERE / "limits" / f"{w['name']}.json").is_file()


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert one_line(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m["workloads"]) <= set(moved)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
        assert spec.reader_path(m["name"]).is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        reported = [n for n, m in e2e.items()
                    if cell in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.metrics_of(BENCH, cell, trace=True)


def test_every_configuration_and_mix_loads():
    for w in BENCH["workloads"]:
        cfg = spec.config(BENCH, w["config"])
        mix = spec.traffic(w["traffic"])
        assert callable(spec.generator(mix))
        assert cfg["folds"] >= 1 and cfg["input_dim_list"]
        assert set(spec.limits(w["name"])) == {"loss_gap", "ll_gap",
                                               "change_gap"}


def test_a_new_config_mix_cell_and_metric_need_no_edit(tmp_path):
    """Copy the benchmark, add a configuration, a mix of an existing
    generator, a cell, its limits and a per-layer metric (a reader of its
    own, found under the name before the metric's last dot) as new files
    and entries; the copy's harness runs the new cell (small shapes, on
    the CPU) and reads the new metric, and no file of the copy was
    edited."""
    shutil.copytree(spec.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*")
              if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = json.loads((spec.HERE / "configs" / "adni_uca_gpoe.json")
                      .read_text())
    base.update(name="tiny_se_gpoe", input_dim_list=[6, 8], hidden_dim=[7],
                latent_dim=2, c_dim=4, folds=2, epochs=3, batch_size=8,
                subjects_per_fold=20, reduced=[])
    pb = tmp_path / "perfbench"
    (pb / "configs" / "tiny_se_gpoe.json").write_text(json.dumps(base))
    (pb / "traffic" / "short_jobs.json").write_text(json.dumps({
        "generator": "train_jobs", "pool": 2, "check_steps": 9,
        "loss_epochs": 2, "warm_epochs": 1, "trace_units": 9}))
    (pb / "limits" / "tiny_se_gpoe.short_jobs.json").write_text(
        json.dumps({"loss_gap": 1e-4, "ll_gap": 1e-4, "change_gap": 0.02}))
    (pb / "metrics" / "steps_per_job.py").write_text(textwrap.dedent('''
        def read(ctx):
            return ctx.window.units / ctx.window.attempted
        '''))
    bench["configs"].append({"name": "tiny_se_gpoe", "source": "a test",
                             "file": "perfbench/configs/tiny_se_gpoe.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny_se_gpoe.short_jobs",
                               "config": "tiny_se_gpoe",
                               "traffic": "short_jobs", "chips": 1,
                               "why": "a test"})
    rate = [m for m in bench["end_to_end"]
            if m["name"] == "train_samples_per_s"][0]
    rate["workloads"].append("tiny_se_gpoe.short_jobs")
    bench["per_layer"].append({"name": "steps_per_job.tiny",
                               "unit": "steps/job", "better": "higher",
                               "source": "host_clock", "layer": "trainer",
                               "moves": "train_samples_per_s",
                               "workloads": ["tiny_se_gpoe.short_jobs"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = textwrap.dedent(f'''
        import json, sys
        sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]
        from perfbench import harness, spec
        assert str(spec.HERE).startswith({str(tmp_path)!r})
        r = harness.run_cell("tiny_se_gpoe.short_jobs", 5, 0.2, False, "cpu")
        # a traced run needs the card: read the per-layer metrics of a
        # window as it would
        win = harness.Window(attempted=4, elapsed_s=1.0, units=36, samples=9)
        ctx = harness.Context("tiny_se_gpoe.short_jobs", 1.0, win, None, 0.0)
        r["metrics"].update(spec.read_metrics(spec.metrics_of(
            spec.load_benchmark(), "tiny_se_gpoe.short_jobs", True), ctx))
        print(json.dumps(r))
        ''')
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    # the cells' own per-layer lists leave the new cell out of the rest
    assert set(result["metrics"]) == {"setup_s", "train_samples_per_s",
                                      "steps_per_job.tiny"}
    assert result["metrics"]["steps_per_job.tiny"]["value"] == 9.0
    after = {p: p.read_bytes() for p in before}
    assert after == before
