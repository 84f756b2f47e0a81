"""The ADHD cell (adhd_se_gpoe_h460.train_fused): its configuration and
limits found by name, its work counts by hand, and the readers of K5's
wide-hidden route on hand-built traces."""
import pytest

from perfbench import devtrace, harness, spec, work, work_decoder

BENCH = spec.load_benchmark()
CELL = "adhd_se_gpoe_h460.train_fused"
ADHD = spec.config(BENCH, "adhd_se_gpoe_h460")
ROUTE = ("void mmnm_ts::dec_wide_hidden_kernel<float>(mmnm_ts::Dims, "
         "mmnm_ts::Net<float const>, mmnm_ts::Batch<float>, "
         "mmnm_ts::Scratch<float>)")


def test_adhd_cell_loads_and_its_decoder_share():
    """The ADHD grid's widest point through spec.py: 2 x 116 features,
    hidden [460, 460], latent 40; the decoder is 48.5% of a row's forward
    multiply-adds (296,700 of 611,800 a modality), 17.97 GFLOP a step."""
    cell = spec.workload(BENCH, CELL)
    assert cell["config"] == "adhd_se_gpoe_h460" and cell["chips"] == 1
    assert cell["traffic"] == "train_fused"
    assert set(spec.limits(CELL)) == {"loss_gap", "ll_gap", "change_gap"}
    dims, c, hidden, z = [116, 116], 29, [460, 460], 40
    assert (ADHD["input_dim_list"], ADHD["c_dim"], ADHD["hidden_dim"],
            ADHD["latent_dim"]) == (dims, c, hidden, z)
    assert (ADHD["folds"], ADHD["epochs"], ADHD["subjects_per_fold"],
            ADHD["reduced"]) == (10, 500, 441, [])
    dec = work.decoder_mac(116, c, hidden, z)[0]
    assert dec == 69 * 460 + 460 * 460 + 460 * 116 == 296700
    fwd = work.forward_mac(dims, c, hidden, z)
    assert fwd == 2 * 611800
    assert 2 * dec / fwd == pytest.approx(0.485, abs=5e-4)
    assert work.train_step(ADHD).flop / 1e9 == pytest.approx(17.97, rel=1e-3)
    assert 10 * work.model_params(dims, c, hidden, z) == 12279060


def test_decoder_pass_work_by_hand():
    """Pass 3 at the ADHD cell: the forward mean path and its input
    gradients but the one into c, 441 rows a fold over 2 steps an epoch;
    bound by operations (76.4 us a step against 19.0 us of bytes)."""
    assert work_decoder.steps_per_epoch(ADHD) == 2
    assert work_decoder.mean_rows(ADHD) == 220.5
    mac = 2 * 296700 - 29 * 460
    assert work_decoder.decoder_pass_mac(116, 29, [460, 460], 40) == mac
    w = work_decoder.decoder_pass_per_step(ADHD)
    assert w.flop == 2.0 * 10 * 220.5 * 2 * mac
    params = 2 * (69 * 460 + 460 + 460 * 460 + 460 + 460 * 116 + 116 + 116)
    per_row = (40 + 29 + 1) + 2 * (3 * 116 + 2 * 920 + 1 + 40)
    assert w.bytes == 4 * (10 * params + 10 + 10 * 220.5 * per_row)
    assert w.bound_s == pytest.approx(w.flop / 67e12)
    assert w.bound_s * 1e6 == pytest.approx(76.36, rel=1e-3)
    assert w.bytes / 3.35e12 * 1e6 == pytest.approx(19.03, rel=1e-3)


def route_trace(route_name):
    """A window of 1000 us with two steps: each an encoder kernel (100 us),
    the decoder pass under ``route_name`` (300 us) and K7 (50 us)."""
    host = {"pid": 1, "tid": 7, "ph": "X", "cat": "user_annotation",
            "name": devtrace.WINDOW, "ts": 0, "dur": 1000}
    dev = {"pid": 0, "tid": 9, "ph": "X", "cat": "kernel"}
    events = [host]
    for at in (0, 500):
        events += [dict(dev, name="void mmnm_ts::enc_fwd_kernel<float>()",
                        ts=at, dur=100),
                   dict(dev, name=route_name, ts=at + 100, dur=300),
                   dict(dev, name="mmnm_masked_adam", ts=at + 400, dur=50)]
    return devtrace.Trace(events)


def context(trace, units=2):
    return harness.Context(CELL, 1.0, harness.Window(), None, 0.0, trace,
                           units)


def test_the_wide_hidden_route_readers():
    """The route's device time (600 us) over the busy time (900 us), and
    two steps of the ADHD cell's decoder pass at its least time (76.36 us
    each) over that device time."""
    ctx = context(route_trace(ROUTE))
    share = spec.reader("dec_wide_share_pct.train")(ctx)
    assert share == pytest.approx(100.0 * 600 / 900)
    least = work_decoder.decoder_pass_per_step(ADHD).bound_s
    roof = spec.reader("dec_wide_roofline_pct.train")(ctx)
    assert roof == pytest.approx(100.0 * 2 * least / 600e-6)
    assert roof == pytest.approx(25.45, rel=1e-3)
    # the wide route's three kernels of the same route count together
    wide = [ROUTE.replace("dec_wide", name) for name in
            ("dec_fwd_wide", "mean_wide", "dec_bwd_wide")]
    assert all(work_decoder.ROUTE_KERNEL in name for name in wide)


@pytest.mark.parametrize("name", ["void mmnm_ts::dec_kernel<float>(x)",
                                  "void mmnm_ts::mean_kernel<float>(x)"])
def test_the_route_readers_find_nothing_on_another_route(name):
    """A step whose decoder pass took the one-pass or the wide route (a
    program without the wide-hidden route, or a silent fallback), and an
    untraced run, give None."""
    for metric in ("dec_wide_share_pct.train", "dec_wide_roofline_pct.train"):
        assert spec.reader(metric)(context(route_trace(name))) is None
        untraced = harness.Context(CELL, 1.0, harness.Window(), None, 0.0)
        assert spec.reader(metric)(untraced) is None
