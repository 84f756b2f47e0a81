"""The launch plans of the decode+deviation and decoder_nll kernels, and
decoder_nll under a non-uniform cotangent against the JAX package's.

The plans are pure Python (kernels/decoder_nll.py::plan,
kernels/deviation.py::plan over _build.fill_split): grids, splits, shared
memory and scratch sizes from the shapes alone, so they are held here, on
the CPU, at chip_smoke.py's shapes and over a sweep. The kernels that run
them are held to their plain versions on the card (tests marked ``cuda``,
chip_smoke.py).
"""
import importlib
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from multi_modal_normative_modeling_tpu.kernels.decoder_nll import (
    decoder_nll as jax_decoder_nll,
)
from multi_modal_normative_modeling_tpu_torch.kernels import (
    _build,
    decoder_nll as decoder_nll_fn,
    deviation,
)

# the module: the package's attribute of that name is the function
nll = importlib.import_module(
    "multi_modal_normative_modeling_tpu_torch.kernels.decoder_nll")

ROOT = Path(__file__).resolve().parents[1]
SLOTS = _build.SMS * _build.BLOCKS_PER_SM


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()


def _covered(count, split):
    """Which block walks each of `count` steps when block s takes s,
    s + split, ...: every step exactly once."""
    steps = sorted(j for s in range(split) for j in range(s, count, split))
    return steps == list(range(count))


def _check_nll_plan(folds, rows, hidden, d):
    p = nll.plan(folds, rows, hidden, d)
    assert p is nll.plan(folds, rows, hidden, d)       # cached per shape
    assert p.tiles == -(-rows // 32) and p.chunks == -(-d // 128)
    assert p.hblocks == -(-hidden // 128)
    assert 1 <= p.fwd_split <= p.chunks and 1 <= p.bwd_split <= p.tiles
    assert _covered(p.chunks, p.fwd_split) and _covered(p.tiles, p.bwd_split)
    # a launch fills the card wherever the work allows it
    for blocks, most in (
            (p.fwd_blocks * folds, p.tiles * p.chunks * folds),
            (p.bwd_blocks * folds, p.tiles * p.chunks * p.hblocks * folds)):
        assert blocks >= min(_build.SMS, most)
    # scratch as documented: tickets and one partial a forward block; the dg
    # partials with more than one chunk, the dW/db/dlvo ones with a split
    assert p.fwd_scratch == folds + folds * p.tiles * p.fwd_split
    want = (p.chunks * folds * rows * hidden if p.chunks > 1 else 0) + (
        p.bwd_split * folds * d * (hidden + 2) if p.bwd_split > 1 else 0)
    assert p.bwd_scratch == want
    assert p.smem == _build.decoder_nll_smem(hidden)
    assert _build.decoder_nll_fwd_smem(hidden) <= p.smem
    return p


@pytest.mark.parametrize("shape", CS.NLL_SHAPES, ids=str)
def test_decoder_nll_plan_at_the_smoke_shapes(shape):
    p = _check_nll_plan(*shape)
    assert p.smem <= _build.MAX_SMEM_BYTES
    # two blocks share an SM at the flagship's hidden width
    assert 2 * p.smem <= _build.MAX_SMEM_BYTES


def test_decoder_nll_plan_of_one_ppmi_fold():
    """256 x 3485 is 8 row tiles x 28 column chunks: both launches get all
    224 (tile, chunk) pairs as blocks, one wave at two blocks an SM."""
    p = nll.plan(1, 256, 110, 3485)
    assert (p.fwd_split, p.bwd_split) == (28, 8)
    assert p.fwd_blocks == p.bwd_blocks == 224 <= SLOTS
    # and the flagship's widest modality: 5 folds x 8 tiles x 3 chunks
    q = nll.plan(5, 256, 110, 270)
    assert (q.fwd_split, q.bwd_split) == (3, 8)
    assert q.fwd_blocks * 5 == q.bwd_blocks * 5 == 120


@settings(max_examples=200, deadline=None, database=None)
@given(st.integers(1, 6), st.integers(1, 2100), st.integers(1, 600),
       st.integers(1, 4000))
def test_decoder_nll_plan_sweep(folds, rows, hidden, d):
    _check_nll_plan(folds, rows, hidden, d)


def _check_deviation_plan(folds, rows, k_in, hidden, d):
    p = deviation.plan(folds, rows, k_in, tuple(hidden), d)
    assert p is deviation.plan(folds, rows, k_in, tuple(hidden), d)
    assert p.tiles == -(-rows // 32) and p.chunks == -(-d // 128)
    assert 1 <= p.groups <= p.chunks and _covered(p.chunks, p.groups)
    assert p.blocks * folds >= min(_build.SMS, p.tiles * p.chunks * folds)
    assert p.scratch == (folds * p.tiles + p.groups * folds * rows
                         if p.groups > 1 else 0)
    assert p.smem == _build.pred_deviation_smem(max(k_in, *hidden, 1))
    return p


@pytest.mark.parametrize("shape", CS.SHAPES, ids=str)
def test_pred_deviation_plan_at_the_smoke_shapes(shape):
    folds, rows, d, c_dim = shape
    p = _check_deviation_plan(folds, rows, CS.LATENT + c_dim, CS.HIDDEN, d)
    assert 2 * p.smem <= _build.MAX_SMEM_BYTES
    # PPMI width takes the column-group route (1000 rows with a ragged last
    # tile), the flagship's widths do not
    assert (p.groups > 1) == (d == 3485)
    if d == 3485:
        assert _build.SMS <= p.blocks <= SLOTS


@settings(max_examples=200, deadline=None, database=None)
@given(st.integers(1, 6), st.integers(1, 4100), st.integers(1, 60),
       st.lists(st.integers(1, 500), max_size=3), st.integers(1, 4000))
def test_pred_deviation_plan_sweep(folds, rows, k_in, hidden, d):
    _check_deviation_plan(folds, rows, k_in, hidden, d)


def test_fill_split_takes_the_fewest_block_times():
    slots = SLOTS
    for blocks, loop in ((8, 28), (40, 3), (140, 8), (1, 1), (300, 5)):
        s = _build.fill_split(blocks, loop)
        cost = -(-blocks * s // slots) * -(-loop // s)
        assert all(cost <= -(-blocks * t // slots) * -(-loop // t)
                   for t in range(1, loop + 1))
    # work that every block repeats weighs against splitting past one wave
    assert _build.fill_split(32, 28, unit=0.95) == 7
    assert _build.fill_split(160, 3, unit=1.16) == 1
    assert _build.fill_split(160, 3) == 3


def test_shared_memory_mirrors():
    """The sizes _build.py mirrors from csrc/tile_product.cuh (the library
    reports its own at load and load_library compares)."""
    assert _build.tile_ld(110) == 120 and _build.tile_ld(529) == 536
    for width in (1, 12, 39, 110, 460, 529):
        ld = _build.tile_ld(width)
        assert ld >= width and ld % 4 == 0 and ld % 16 == 8
    assert _build.RING_BYTES == 3 * 128 * 36 * 4
    assert _build.decoder_nll_smem(110) == (55296 + 32 * 120 * 4
                                            + 32 * 136 * 4 + 2048)
    assert _build.pred_deviation_smem(110) == 55296 + 2 * 32 * 120 * 4 + 512
    source = (_build.SRC_DIR / "tile_product.cuh").read_text()
    for line in ("constexpr int TM = 32;", "constexpr int BN = 128;",
                 "constexpr int BK = 32;", "constexpr int SLOTS = 3;",
                 "constexpr int DMS = BN + 8;"):
        assert line in source
    # both sources build on tile_product.cuh alone, not the encoder's header
    for name in ("decoder_nll.cu", "pred_deviation.cu"):
        text = (_build.SRC_DIR / name).read_text()
        assert '#include "tile_product.cuh"' in text
        assert "tile_mlp.cuh" not in text
        assert "atomicAdd(" not in text      # the one ticket is the header's
    assert "cudaFuncSetAttribute" not in (
        _build.SRC_DIR / "decoder_nll.cu").read_text()


def test_decoder_nll_refuses_too_wide_a_hidden_layer():
    wide = 1800
    assert _build.decoder_nll_smem(wide) > _build.MAX_SMEM_BYTES
    g = torch.zeros(1, 4, wide)
    w = torch.zeros(1, 8, wide)
    with pytest.raises(ValueError, match="shared memory"):
        nll._check(g, w, torch.zeros(1, 8), torch.zeros(1, 1, 8),
                   torch.zeros(1, 4, 8), torch.ones(1, 4), torch.ones(1))


# ---- decoder_nll under a non-uniform cotangent ----------------------------

@pytest.mark.parametrize("b,h,d,tol", [
    (20, 11, 37, dict(rtol=1e-4, atol=1e-6)),
    (40, 110, 300, dict(rtol=1e-4, atol=1e-6)),
])
def test_decoder_nll_nonuniform_cotangent_matches_jax(b, h, d, tol):
    """loss = sum_f a_f ll_f with distinct a_f, one of them 0: the port's
    decoder_nll on CPU tensors against JAX decoder_nll (Pallas in interpret
    mode) per fold, value rtol 1e-5, gradients rtol 1e-4 / atol 1e-6. The
    CUDA kernels scale dmean by gbar / n inside their epilogue, so a fold's
    cotangent must reach every gradient of that fold and no other."""
    rng = np.random.default_rng(b + d)
    folds = 3
    a = np.array([1.5, 0.0, -0.25], np.float32)
    g = (rng.standard_normal((folds, b, h)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((folds, h, d)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal((folds, d)) * 0.1).astype(np.float32)
    lvo = (rng.standard_normal((folds, 1, d)) * 0.1 - 1.0).astype(np.float32)
    x = rng.standard_normal((folds, b, d)).astype(np.float32)
    mask = np.ones((folds, b), np.float32)
    for f in range(folds):
        mask[f, b - 2 - f:] = 0.0
    n = np.maximum(mask.sum(-1), 1.0)

    tg, tw, tb, tl = (torch.tensor(t, requires_grad=True) for t in (
        g, np.swapaxes(w, 1, 2).copy(), bias, lvo))
    ll = decoder_nll_fn(tg, tw, tb, tl, torch.from_numpy(x),
                        torch.from_numpy(mask), torch.from_numpy(n))
    grads = torch.autograd.grad((torch.from_numpy(a) * ll).sum(),
                                (tg, tw, tb, tl))
    for f in range(folds):
        def fn(g_, w_, b_, lvo_, f=f):
            return jax_decoder_nll(g_, w_, b_, lvo_, x[f], mask[f], n[f],
                                   tile_b=8, interpret=True)
        val, ref = jax.value_and_grad(
            lambda *p, f=f: a[f] * fn(*p), argnums=(0, 1, 2, 3))(
            g[f], w[f], bias[f], lvo[f])
        np.testing.assert_allclose(a[f] * ll[f].item(), float(val),
                                   rtol=1e-5, atol=0.0)
        got = (grads[0][f], grads[1][f].T, grads[2][f], grads[3][f])
        for t, r in zip(got, ref):
            np.testing.assert_allclose(t.numpy(),
                                       np.asarray(r).reshape(t.shape), **tol)
        if a[f] == 0.0:
            assert all(float(t.abs().max()) == 0.0 for t in got)
