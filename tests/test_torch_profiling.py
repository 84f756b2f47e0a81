"""utils/profiling.py and ``--profile_dir``, on the CPU.

``trace`` writes one Chrome-trace JSON under its directory that holds an
``annotate`` region; asked for CUDA activity with no card it raises (a
device trace is never silently a host-only one). ``Timer`` and ``timed``
return the JAX package's dicts (the same keys, the same repeat count).
``--profile_dir`` wraps the train CLI's and the pipeline's run in ``trace``.
"""
import json
import shutil
import time

import pytest
import torch

from multi_modal_normative_modeling_tpu.utils import profiling as jax_prof
from multi_modal_normative_modeling_tpu_torch.cli import (
    pipeline,
    train_supervised,
)
from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
    make_synthetic_resource,
)
from multi_modal_normative_modeling_tpu_torch.utils import profiling
from tests.test_torch_threads import one_torch_thread  # noqa: F401

FLAGS = ["-R", "ADNI", "-P", "SE-MoE", "-K", "2", "-H", "8", "8", "4", "-E",
         "1", "--device", "cpu"]


def _events(path):
    return json.loads(path.read_text())["traceEvents"]


def test_trace_holds_an_annotated_region(tmp_path):
    with profiling.trace(tmp_path / "trace"):
        with profiling.annotate("mmnm-region"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    written = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert written == [profiling.trace.last]
    names = {e.get("name") for e in _events(written[0])}
    assert "mmnm-region" in names
    assert any("mm" in str(n) for n in names)


def test_trace_asked_for_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profiling.trace(tmp_path, cuda=True):
            pass
    assert not list(tmp_path.iterdir())


def test_timer_and_timed_return_the_jax_dicts():
    def work(n):
        time.sleep(0.001)
        return [torch.ones(n), {"last": torch.zeros(n)}]

    got = profiling.Timer(warmup=1, repeats=4).measure(work, 3)
    want = jax_prof.Timer(warmup=1, repeats=4).measure(
        lambda n: time.sleep(0.001), 3)
    assert set(got) == set(want) == {"median_s", "min_s", "times_s"}
    assert len(got["times_s"]) == len(want["times_s"]) == 4
    assert got["min_s"] <= got["median_s"] and got["min_s"] >= 0.001
    result, stats = profiling.timed(work, 2, warmup=0, repeats=2)
    assert torch.equal(result[1]["last"], torch.zeros(2))
    assert set(stats) == {"median_s", "min_s", "times_s"}
    assert profiling._last_tensor(result) is result[1]["last"]


@pytest.mark.parametrize("cli", ["train_supervised", "pipeline"])
def test_profile_dir_traces_the_run(cli, tmp_path):
    make_synthetic_resource(tmp_path / "cohort", "ADNI", n_hc=20,
                            n_disease={0: 6, 1: 6})
    shutil.copytree(tmp_path / "cohort" / "data", tmp_path / "p" / "data")
    run = {"train_supervised": train_supervised.run,
           "pipeline": pipeline.run}[cli]
    argv = FLAGS + ["--profile_dir", str(tmp_path / "trace")]
    if cli == "pipeline":
        argv += ["--stages", "train,test"]
    run(argv, project_root=tmp_path / "p")
    written = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(written) == 1
    events = _events(written[0])
    assert sum(e.get("cat") == "cpu_op" for e in events) > 100
    assert (tmp_path / "p" / "outputs" / "kfold_analysis"
            / "supervised_cvae" / "001" / "cVAE_model.ckpt").exists()
