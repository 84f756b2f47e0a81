"""perfbench/spans.py and the readers of the program's spans: on
hand-built traces (nested and repeated spans, gaps that cross a span's
edge), on a trace without the program's spans, and on a small cell
profiled on the CPU."""
import json

import pytest

from perfbench import devtrace, harness, spans, spec

READERS = ["idle_in_batches_pct.train", "idle_in_job_setup_pct.train",
           "idle_in_steps_pct.train", "host_us_per_step.train",
           "pack_ms_per_job.train", "upload_ms_per_job.train",
           "job_setup_ms.train"]


def job_events(t, pack):
    """One job from ``t`` (us) as the generator and the program mark it,
    packing for ``pack`` us, with three kernels on the device:

      perfbench.batches      t+0    .. t+200
        mmnm.fused.batches   t+10   .. t+190   (pack, then upload)
      perfbench.run          t+200  .. t+1000
        mmnm.fused.session   t+210  .. t+250
        mmnm.session.advance t+250  .. t+950
          mmnm.step x3       t+260  .. t+680   (140 us each)
          mmnm.session.fetch t+900  .. t+940
        mmnm.fused.trained   t+950  .. t+990
      kernels                t+150  .. t+230, t+300 .. t+450,
                             t+600  .. t+920
    """
    host = {"pid": 1, "tid": 7, "ph": "X", "cat": "user_annotation"}
    dev = {"pid": 0, "tid": 9, "ph": "X", "cat": "kernel"}

    def mark(name, start, end):
        return dict(host, name=name, ts=t + start, dur=end - start)

    events = [mark("perfbench.batches", 0, 200),
              mark("mmnm.fused.batches", 10, 190),
              mark("mmnm.fused.pack", 10, 10 + pack),
              mark("mmnm.fused.upload", 10 + pack, 190),
              mark("perfbench.run", 200, 1000),
              mark("mmnm.fused.session", 210, 250),
              mark("mmnm.session.advance", 250, 950),
              mark("mmnm.session.fetch", 900, 940),
              mark("mmnm.fused.trained", 950, 990)]
    for k in range(3):
        at = 260 + 140 * k
        events += [mark("mmnm.step", at, at + 140),
                   mark("mmnm.step.inputs", at, at + 20),
                   mark("mmnm.step.kernel", at + 20, at + 40),
                   mark("mmnm.step.adam", at + 50, at + 140)]
        if k == 0:
            events.append(mark("mmnm.step.log", at + 40, at + 50))
        events.append(dict(host, cat="cpu_op", name="aten::mul",
                           ts=t + at + 60, dur=10))
    events += [dict(dev, name="k", ts=t + a, dur=b - a)
               for a, b in ((150, 230), (300, 450), (600, 920))]
    return events


def two_jobs():
    """A window of 2000 us holding two jobs (packing 90 and 50 us)."""
    window = {"pid": 1, "tid": 7, "ph": "X", "cat": "user_annotation",
              "name": devtrace.WINDOW, "ts": 0, "dur": 2000}
    return devtrace.Trace([window] + job_events(0, 90)
                          + job_events(1000, 50))


def context(trace, units=6):
    return harness.Context("adni_uca_gpoe.train_fused", 1.0,
                           harness.Window(), None, 0.0, trace, units)


def test_idle_time_under_a_family_is_an_exact_intersection():
    trace = two_jobs()
    # gaps 0-150, 230-300, 450-600, 920-1150 (into the second job),
    # 1230-1300, 1450-1600, 1920-2000: 900 us
    assert sum(b - a for a, b in trace.gaps()) == pytest.approx(900)
    # each job's batches 10-190 meets the gap before its first kernel:
    # 10-150 and 1010-1150, where a gap's middle would name one or none
    assert spans.idle_s(trace, "mmnm.fused.batches") == pytest.approx(280e-6)
    # nested spans of one family count each idle instant once
    assert spans.idle_s(trace, "mmnm.fused.batches",
                        "mmnm.fused.pack") == pytest.approx(280e-6)
    # the session's 230-250, the fetch's 920-940, the unpadding's 950-990
    assert spans.idle_s(trace, "mmnm.fused.session", "mmnm.session.fetch",
                        "mmnm.fused.trained") == pytest.approx(160e-6)
    # the steps' 260-300 and 450-600 in each job
    assert spans.idle_s(trace, "mmnm.step") == pytest.approx(380e-6)
    everything = [(a, b) for a, b, name, _ in trace.host
                  if name.startswith("mmnm.")]
    outside = (900e-6 - spans.overlap_s(spans.union(trace.gaps()),
                                        spans.union(everything)))
    assert outside == pytest.approx(40e-6)    # 0-10, 990-1010, 1990-2000
    assert spans.idle_s(trace, "mmnm.no_such_span") is None


def test_overlap_of_two_unions():
    a = spans.union([(0, 10), (5, 20), (30, 40)])
    assert a == [(0, 20), (30, 40)]
    b = [(15, 35), (38, 50)]
    assert spans.overlap_s(a, b) == pytest.approx(12e-6)
    assert spans.overlap_s(b, a) == pytest.approx(12e-6)
    assert spans.overlap_s([], a) == 0.0


def test_the_span_readers():
    read = {m: spec.reader(m)(context(two_jobs())) for m in READERS}
    assert read == {
        "idle_in_batches_pct.train": pytest.approx(14.0),
        "idle_in_job_setup_pct.train": pytest.approx(8.0),
        "idle_in_steps_pct.train": pytest.approx(19.0),
        "host_us_per_step.train": pytest.approx(140.0),
        "pack_ms_per_job.train": pytest.approx(0.070),    # (90 + 50) / 2
        "upload_ms_per_job.train": pytest.approx(0.110),  # (90 + 130) / 2
        "job_setup_ms.train": pytest.approx(0.080),       # (80 + 80) / 2
    }
    # with the idle time inside a chunk but outside its steps and fetch
    # (250-260 and 940-950 a job, 2%) and outside every program span (2%),
    # the shares add up to the device's idle share
    idle = spec.reader("device_idle_pct.train")(context(two_jobs()))
    assert idle == pytest.approx(45.0)
    assert sum(read[m] for m in READERS[:3]) + 2.0 + 2.0 == pytest.approx(
        idle)


def test_without_the_programs_spans_every_reader_finds_nothing(capsys):
    window = {"pid": 1, "tid": 7, "ph": "X", "cat": "user_annotation",
              "name": devtrace.WINDOW, "ts": 0, "dur": 1000}
    bare = [e for e in job_events(0, 90) if not e["name"].startswith("mmnm.")]
    ctx = context(devtrace.Trace([window] + bare))
    assert ctx.trace.kernels == 3
    for metric in READERS:
        assert spec.reader(metric)(ctx) is None, metric
    ctx.trace = None
    for metric in READERS:
        assert spec.reader(metric)(ctx) is None, metric
    entries = [{"name": m, "unit": "%"} for m in READERS]
    assert spec.read_metrics(entries, context(devtrace.Trace(
        [window] + bare))) == {}
    err = capsys.readouterr().err
    assert all(f"{m} found nothing" in err for m in READERS)


@pytest.mark.parametrize("cell", ["adni_uca_gpoe.train_fused",
                                  "ppmi_se_gpoe.train_fused"])
def test_the_readers_find_every_family_in_a_profiled_small_cell(
        small, cell, tmp_path):
    """A job of a small cell under the CPU profiler, read as the
    benchmark's traced run reads its window (no device: all idle)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    parts = small(cell)
    cell_gen = spec.generator(parts["mix"])(parts["cfg"], parts["mix"],
                                            2**31 + 5, "cpu")
    cell_gen.warm()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(devtrace.WINDOW):
            cell_gen.item(0)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = devtrace.Trace(json.loads(path.read_text())["traceEvents"])
    ctx = context(trace, cell_gen.units_of(1))
    read = {m: spec.reader(m)(ctx) for m in READERS}
    assert all(v is not None and v > 0 for v in read.values()), read
    idle = spec.reader("device_idle_pct.train")(ctx)
    assert idle == pytest.approx(100.0)
    assert sum(read[m] for m in READERS[:3]) <= idle + 1e-9
    steps = spans.durations(trace, "mmnm.step")
    assert len(steps) == cell_gen.units_of(1)
    assert len(spans.durations(trace, "mmnm.fused.pack")) == 1
    assert read["host_us_per_step.train"] == pytest.approx(
        1e6 * sum(steps) / len(steps))
