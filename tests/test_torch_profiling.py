"""utils/profiling.py and ``--profile_dir``, on the CPU.

``trace`` writes one Chrome-trace JSON under its directory that holds an
``annotate`` region; asked for CUDA activity with no card it raises (a
device trace is never silently a host-only one). ``annotate`` is one
shared null context while no profiler runs; under one, a fused training
job writes the ``mmnm.*`` span tree and trains bit for bit as without. ``Timer`` and ``timed``
return the JAX package's dicts (the same keys, the same repeat count).
``--profile_dir`` wraps the train CLI's and the pipeline's run in ``trace``.
"""
import json
import shutil
import time

import jax
import numpy as np
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
from multi_modal_normative_modeling_tpu_torch.interop import (
    packed_from_model,
)
from multi_modal_normative_modeling_tpu_torch.models import build_model
from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
from multi_modal_normative_modeling_tpu_torch.train.fused import (
    FusedFoldTrainer,
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


def test_annotate_is_one_null_context_until_a_profiler_runs(tmp_path):
    off = profiling.annotate("mmnm-off")
    assert off is profiling.annotate("another") is profiling.annotate("x")
    with off:
        with off:          # shared and nestable
            pass
    with profiling.trace(tmp_path, cuda=False):
        on = profiling.annotate("mmnm-on")
        assert on is not off
        with on:
            torch.ones(3).sum()
    marks = [e for e in _events(profiling.trace.last)
             if e.get("cat") == "user_annotation"]
    assert [e["name"] for e in marks] == ["mmnm-on"]
    assert profiling.annotate("after") is off


def _fused_job(profile_dir=None):
    """A fused job of 3 folds x 16 rows at batch 8 (2 batches), 2 epochs,
    from one seeded init and replayed noise; under ``trace`` when a
    directory is given."""
    dims, latent = [7, 5], 3
    model = build_model("cVAE_multimodal", dims, [6], latent, 2, len(dims),
                        folds=3, generator=torch.Generator().manual_seed(0))
    trainer = FusedFoldTrainer(
        model, TrainConfig(epochs=2, batch_size=8, combine="gpoe"), 16)
    rng = np.random.default_rng(5)
    data = [[rng.standard_normal((16, d)).astype(np.float32) for d in dims]
            for _ in range(3)]
    cov = [rng.standard_normal((16, 2)).astype(np.float32) for _ in range(3)]
    eps = rng.standard_normal((4, 3, 8, latent)).astype(np.float32)
    packed = packed_from_model(model, trainer.stacked)

    def job():
        batches = trainer.batches(data, cov, "cpu")
        return trainer.run(packed, batches, eps=eps)

    if profile_dir is None:
        return job()
    with profiling.trace(profile_dir, cuda=False):
        return job()


def _span_tree(events):
    """The user_annotation ranges as nested (name, [children]) by
    containment, outermost first."""
    marks = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in events
                    if e.get("cat") == "user_annotation"),
                   key=lambda m: (m[0], -m[1]))
    roots, stack = [], []
    for start, end, name in marks:
        while stack and stack[-1][0] < end:
            stack.pop()
        node = (name, [])
        (stack[-1][1][1] if stack else roots).append(node)
        stack.append((end, node))
    return roots


def test_a_fused_job_writes_the_span_tree(tmp_path):
    _fused_job(tmp_path)
    step = ("mmnm.step", [("mmnm.step.inputs", []), ("mmnm.step.kernel", []),
                          ("mmnm.step.adam", [])])
    logged = ("mmnm.step", [("mmnm.step.inputs", []),
                            ("mmnm.step.kernel", []),
                            ("mmnm.step.log", []), ("mmnm.step.adam", [])])

    def names_only(nodes):
        return [(n, names_only(c)) for n, c in nodes
                if n.startswith("mmnm.")]

    assert names_only(_span_tree(_events(profiling.trace.last))) == [
        ("mmnm.fused.batches", [("mmnm.fused.pack", []),
                                ("mmnm.fused.upload", [])]),
        ("mmnm.fused.session", []),
        ("mmnm.session.advance", [logged, step, logged, step,
                                  ("mmnm.session.fetch", [])]),
        ("mmnm.fused.trained", []),
    ]


def test_a_fused_job_trains_bit_for_bit_under_the_profiler(tmp_path):
    plain, plain_logs = _fused_job()
    traced, traced_logs = _fused_job(tmp_path)
    assert set(plain_logs) == set(traced_logs) == {"total", "kl", "ll"}
    for k in plain_logs:
        assert np.array_equal(plain_logs[k], traced_logs[k]), k
    a, b = (jax.tree_util.tree_leaves(t) for t in (plain, traced))
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)


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
