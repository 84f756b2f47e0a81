"""perfbench/work.py's operations and bytes against counts by hand."""
import pytest

from perfbench import spec, work

BENCH = spec.load_benchmark()
ADNI = spec.config(BENCH, "adni_uca_gpoe")
PPMI = spec.config(BENCH, "ppmi_se_gpoe")


def layers(d, c=29, h=110, z=10):
    """Every product of one modality as (fan_in, fan_out), written out:
    the encoder [x | c] -> 110 -> 110 -> mu, logvar; the decoder
    [z | c] -> 110 -> 110 -> mean."""
    enc = [(d + c, h), (h, h), (h, z), (h, z)]
    dec = [(z + c, h), (h, h), (h, d)]
    return enc, dec


def fwd_mac(dims):
    return sum(k * n for d in dims for part in layers(d) for k, n in part)


def test_forward_by_hand():
    # ADNI: three modalities of 90 and one of 270
    enc90 = 119 * 110 + 110 * 110 + 2 * 110 * 10
    dec90 = 39 * 110 + 110 * 110 + 110 * 90
    enc270 = 299 * 110 + 110 * 110 + 2 * 110 * 10
    dec270 = 39 * 110 + 110 * 110 + 110 * 270
    by_hand = 3 * (enc90 + dec90) + enc270 + dec270
    assert by_hand == 254320
    assert work.forward_mac([90, 90, 90, 270], 29, [110, 110], 10) == by_hand
    assert fwd_mac([90, 90, 90, 270]) == by_hand
    assert work.forward_mac([3485] * 3, 29, [110, 110], 10) == fwd_mac(
        [3485] * 3)


def test_parameters_by_hand():
    def params(d):
        enc, dec = layers(d)
        return sum(k * n + n for k, n in enc + dec) + d   # + lvo
    assert work.model_params([90, 90, 90, 270], 29, [110, 110], 10) == (
        3 * params(90) + params(270) + 4)                 # + alpha


@pytest.mark.parametrize("cfg, gflop, model_gflop",
                         [(ADNI, 3.472, 3.906), (PPMI, 30.90, 36.89)])
def test_train_step(cfg, gflop, model_gflop):
    rows = cfg["folds"] * cfg["batch_size"]
    fwd = fwd_mac(cfg["input_dim_list"])
    # backward: twice the forward, less the input gradients nobody needs
    # (x and c into the first encoder layer, c into the first decoder one)
    skip = sum((d + 29) * 110 + 29 * 110 for d in cfg["input_dim_list"])
    step = work.train_step(cfg)
    assert step.flop == 2.0 * rows * (3 * fwd - skip)
    assert step.flop / 1e9 == pytest.approx(gflop, rel=1e-3)
    assert work.train_step_model_flops(cfg) == 6.0 * rows * fwd
    assert work.train_step_model_flops(cfg) / 1e9 == pytest.approx(
        model_gflop, rel=1e-3)
    p = cfg["folds"] * work.model_params(cfg["input_dim_list"], 29,
                                         [110, 110], 10)
    batch = rows * (sum(cfg["input_dim_list"]) + 29 + 10 + 1)
    assert step.bytes == 4 * (batch + 3 * cfg["folds"] + 8 * p)
    assert step.bound_s == pytest.approx(step.flop / 67e12)
