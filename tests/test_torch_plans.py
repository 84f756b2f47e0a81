"""The launch plans of the encoder, decode+deviation and decoder_nll
kernels, and decoder_nll under a non-uniform cotangent against the JAX
package's; MaskedAdam's runs table; the fused train step's decoder route
(the one-pass layout or the wide-hidden route).

The plans are pure Python (kernels/mlp.py::plan, kernels/decoder_nll.py::plan,
kernels/deviation.py::plan over _build.fill_split): grids, splits, shared
memory and scratch sizes from the shapes alone, so they are held here, on
the CPU, at chip_smoke.py's shapes and over a sweep. The kernels that run
them are held to their plain versions on the card (tests marked ``cuda``,
chip_smoke.py).
"""
import importlib
import importlib.util
import re
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
    mlp,
    train_step as ts,
)
from multi_modal_normative_modeling_tpu_torch.models import build_model
from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
from multi_modal_normative_modeling_tpu_torch.train.fused import select_kernel
from multi_modal_normative_modeling_tpu_torch.train.trainer import MaskedAdam

# the module: the package's attribute of that name is the function
nll = importlib.import_module(
    "multi_modal_normative_modeling_tpu_torch.kernels.decoder_nll")
adam_kernel = importlib.import_module(
    "multi_modal_normative_modeling_tpu_torch.kernels.masked_adam")

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
    # tile), and so does a cohort's test stage at D = 270 (20 row tiles, 3
    # groups); the flagship's widths at 1024 rows and D = 90 at 128 do not
    assert (p.groups > 1) == (d == 3485 or (rows, d) == (CS.STAGE_ROWS, 270))
    if d == 3485:
        assert _build.SMS <= p.blocks <= SLOTS


@settings(max_examples=200, deadline=None, database=None)
@given(st.integers(1, 6), st.integers(1, 4100), st.integers(1, 60),
       st.lists(st.integers(1, 500), max_size=3), st.integers(1, 4000))
def test_pred_deviation_plan_sweep(folds, rows, k_in, hidden, d):
    _check_deviation_plan(folds, rows, k_in, hidden, d)


def _check_encoder_plan(folds, rows, k_in, hidden, z, splits=None):
    hidden = tuple(hidden)
    p = mlp.plan(folds, rows, k_in, hidden, z, splits)
    assert p is mlp.plan(folds, rows, k_in, hidden, z, splits)   # cached
    assert p.tiles == -(-rows // 32) and p.chunks == -(-k_in // 32)
    # every column of [x | c] lies in exactly one split, and no split is
    # empty; slices are whole chunks
    assert p.k_per % _build.TILE_DEPTH == 0 and 1 <= p.splits <= p.chunks
    assert p.k_per * (p.splits - 1) < k_in <= p.k_per * p.splits
    n0 = hidden[0] if hidden else 2 * z
    assert p.scratch == (folds * p.tiles + p.splits * folds * rows * n0
                         if p.splits > 1 else 0)
    assert p.smem == _build.encoder_smem(p.k_per, max(hidden, default=1))
    if splits is None:
        blocks = p.tiles * p.splits * folds
        assert blocks >= min(_build.SMS, p.tiles * p.chunks * folds)
        # two blocks share an SM unless one chunk's slice is too much
        assert (p.smem <= _build.HALF_SM_SMEM_BYTES
                or p.k_per == _build.TILE_DEPTH)
    return p


@pytest.mark.parametrize("shape,splits,k_per", [
    ((1, 7, 90, 29), 4, 32), ((1, 1000, 3485, 2), 16, 224),
    ((1, 1024, 3485, 2), 16, 224), ((5, 128, 90, 29), 4, 32),
    ((5, 128, 270, 29), 10, 32), ((5, 1024, 90, 29), 1, 128),
    ((5, 1024, 270, 29), 1, 320)], ids=str)
def test_encoder_plan_at_the_smoke_shapes(shape, splits, k_per):
    """One PPMI modality: 32 row tiles x 16 splits of 7 chunks, 512 blocks
    at two an SM; the flagship's modalities at 1024 rows: one block walks
    the whole chain, no scratch, no ticket; at a cohort's test stage (128
    rows, 20 row tiles) every chunk of the first layer is a split."""
    assert shape in CS.SHAPES
    folds, rows, d, c_dim = shape
    p = _check_encoder_plan(folds, rows, d + c_dim, CS.HIDDEN, CS.LATENT)
    assert (p.splits, p.k_per) == (splits, k_per)
    assert p.smem <= _build.HALF_SM_SMEM_BYTES < _build.MAX_SMEM_BYTES
    if splits == 1:
        assert p.scratch == 0
    else:
        assert p.scratch == (folds * p.tiles
                             + splits * folds * rows * CS.HIDDEN[0])


@pytest.mark.parametrize("shape,splits,groups", [
    ((5, 64, 90, 29), 4, 1), ((5, 64, 270, 29), 10, 3),
    ((10, 64, 90, 29), 4, 1), ((10, 64, 270, 29), 10, 3)], ids=str)
def test_plans_at_the_serving_shapes(shape, splits, groups):
    """A scoring request of 1 to 64 subjects runs K1 and K2 at B = 64 (two
    row tiles) over 5 folds or 10 (-K 10, the service's default): every
    chunk of K1's first layer is a split, and K2 takes column groups at
    D = 270 only."""
    assert shape in CS.SERVE_SHAPES
    folds, rows, d, c_dim = shape
    p = _check_encoder_plan(folds, rows, d + c_dim, CS.HIDDEN, CS.LATENT)
    q = _check_deviation_plan(folds, rows, CS.LATENT + c_dim, CS.HIDDEN, d)
    assert (p.tiles, p.splits, p.k_per) == (2, splits, 32)
    assert q.groups == groups
    assert 2 * max(p.smem, q.smem) <= _build.MAX_SMEM_BYTES


@pytest.mark.parametrize("rows", [256, 480, 640])
@pytest.mark.parametrize("d", [90, 270])
def test_plans_at_the_score_cli_rows(rows, d):
    """The rest of phase 11's shapes (5 folds): a 256-subject request, the
    train cohorts of the latent statistics (480 rows) and the score CLI's
    600 subjects padded to 640."""
    p = _check_encoder_plan(CS.FOLDS, rows, d + CS.C_DIM, CS.HIDDEN,
                            CS.LATENT)
    q = _check_deviation_plan(CS.FOLDS, rows, CS.LATENT + CS.C_DIM,
                              CS.HIDDEN, d)
    assert 2 * max(p.smem, q.smem) <= _build.MAX_SMEM_BYTES


@pytest.mark.parametrize("shape,hidden,splits", CS.ENCODER_EXTRA, ids=str)
def test_encoder_plan_at_the_forced_smoke_shapes(shape, hidden, splits):
    folds, rows, d, c_dim = shape
    p = _check_encoder_plan(folds, rows, d + c_dim, hidden, CS.LATENT, splits)
    assert p.smem <= _build.MAX_SMEM_BYTES
    if splits is not None:
        assert p.splits == splits and p.scratch > 0


@settings(max_examples=200, deadline=None, database=None)
@given(st.integers(1, 6), st.integers(1, 2100), st.integers(1, 4000),
       st.lists(st.integers(1, 500), max_size=3), st.integers(1, 40),
       st.one_of(st.none(), st.integers(1, 125)))
def test_encoder_plan_sweep(folds, rows, k_in, hidden, z, splits):
    if splits is not None and splits > -(-k_in // 32):
        with pytest.raises(ValueError, match="splits"):
            mlp.plan(folds, rows, k_in, tuple(hidden), z, splits)
        return
    _check_encoder_plan(folds, rows, k_in, hidden, z, splits)


def test_encoder_plan_without_hidden_layers_and_forced():
    """Without a hidden layer the split applies to the heads: partials of
    2 Z columns. One forced split needs no scratch, whatever the width."""
    p = _check_encoder_plan(3, 65, 48, [], 10)
    assert p.splits == 2 and p.scratch == 3 * 3 + 2 * 3 * 65 * 20
    q = _check_encoder_plan(3, 65, 48, [], 10, splits=1)
    assert (q.splits, q.k_per, q.scratch) == (1, 64, 0)
    # a forced number of splits that leaves one empty is brought down
    r = _check_encoder_plan(2, 70, 328, [110, 110], 10, splits=5)
    assert (r.splits, r.k_per) == (4, 96)
    # one split of a PPMI-wide input does not fit a block: the wrapper
    # refuses it (tests/test_torch_cuda.py), the plan only says so
    wide = mlp.plan(1, 8, 3487, (110,), 10, 1)
    assert wide.smem > _build.MAX_SMEM_BYTES


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
    # a lower bound (a slice that must fit shared memory) is kept
    assert _build.fill_split(160, 10, unit=12.0) == 1
    assert _build.fill_split(160, 10, unit=12.0, least=3) == 3
    assert _build.fill_split(32, 109, unit=12.0, least=11) == 16
    assert _build.fill_split(4, 3, least=9) == 3


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
    # the encoder: the slice and the second activation tile share a region
    assert _build.encoder_smem(320, 110) == 55296 + 32 * (328 + 120) * 4
    assert _build.encoder_smem(32, 110) == 55296 + 32 * (120 + 120) * 4
    assert _build.encoder_smem(224, 1) == 55296 + 32 * (232 + 8) * 4
    assert 2 * (_build.HALF_SM_SMEM_BYTES + 1024) == 228 * 1024
    source = (_build.SRC_DIR / "tile_product.cuh").read_text()
    for line in ("constexpr int TM = 32;", "constexpr int BN = 128;",
                 "constexpr int BK = 32;", "constexpr int SLOTS = 3;",
                 "constexpr int DMS = BN + 8;"):
        assert line in source
    # the three sources build on tile_product.cuh alone
    for name in ("encoder.cu", "decoder_nll.cu", "pred_deviation.cu"):
        text = (_build.SRC_DIR / name).read_text()
        assert '#include "tile_product.cuh"' in text
        assert "tile_mlp.cuh" not in text
        assert "atomicAdd(" not in text      # the one ticket is the header's
    assert not (_build.SRC_DIR / "tile_mlp.cuh").exists()
    assert not hasattr(_build, "_STAGE_BYTES")


def test_no_source_sets_the_shared_memory_attribute_per_launch():
    """cudaFuncSetAttribute is a call into the CUDA runtime: every source
    sets it through an ``ensure_smem``, which remembers what each kernel was
    given on each device, never from a launcher itself."""
    calls = 0
    for path in sorted(_build.SRC_DIR.glob("*.cu*")):
        text = path.read_text()
        for found in re.finditer(r"cudaFuncSetAttribute\(", text):
            # the function it stands in: the last line before it that
            # starts in column 0 with a declaration
            heads = [line for line in text[:found.start()].splitlines()
                     if re.match(r"[A-Za-z_]", line) and "(" in line]
            assert "ensure_smem(" in heads[-1], (path.name, heads[-1])
            calls += 1
        if "<<<" in text and "extern __shared__" in text:
            assert "ensure_smem(" in text, path.name
    assert calls == 2      # tile_product.cuh's and train_step.cuh's


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


@pytest.mark.parametrize("shape", CS.BOOT_SHAPES, ids=str)
def test_plans_at_the_bootstrap_test_call(shape):
    """Phase 13a's bootstrap test stage: 10 replicates as folds of one call,
    their out-of-bag rows padded to 448, the 270-wide early-fusion
    modality, with the cohort's 29 covariate columns and with the constant
    one of --unconditioned (C = 1, a width no other phase gives K1)."""
    folds, rows, d, c_dim = shape
    p = _check_encoder_plan(folds, rows, d + c_dim, CS.HIDDEN, CS.LATENT)
    q = _check_deviation_plan(folds, rows, CS.LATENT + c_dim, CS.HIDDEN, d)
    assert p.tiles == q.tiles == -(-rows // _build.TILE_ROWS)
    assert 2 * max(p.smem, q.smem) <= _build.MAX_SMEM_BYTES


# ---- MaskedAdam's runs table (kernels/masked_adam.py::plan) -----------------

def _old_fold_of(sizes, folds):
    """MaskedAdam's element fold index as it was built on the device."""
    runs = torch.tensor([n // folds for n in sizes for _ in range(folds)])
    return torch.repeat_interleave(
        torch.arange(folds).repeat(len(sizes)), runs)


def _adam_layouts():
    """(name, parameter sizes, folds) of every MaskedAdam construction:
    the fused step's padded layout at both cells' widths (F = 10), the
    plain trainer's per-modality modules, the packed trainer's tree and
    the classifier's configurations."""
    from multi_modal_normative_modeling_tpu_torch.interop import (
        packed_from_model,
    )
    from multi_modal_normative_modeling_tpu_torch.models import build_model
    from multi_modal_normative_modeling_tpu_torch.models.classifier import (
        MLPClassifier,
    )
    from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
    from multi_modal_normative_modeling_tpu_torch.train import packed

    out = [(f"fused {name.lower()}", CS.masked_adam_sizes(dims),
            CS.ADAM_FOLDS) for name, dims in CS.ADAM_LAYOUTS.items()]
    model = build_model("cVAE_multimodal", [12, 20, 8], [16, 16], 4, 29, 3,
                        folds=5, generator=torch.Generator().manual_seed(0))
    out.append(("plain", [p.numel() for p in model.parameters()], 5))
    trainer = packed.PackedMultiFoldTrainer(model, TrainConfig(), 37)
    tree = packed_from_model(model, trainer.layout)
    out.append(("packed", [t.numel() for t in packed._leaves(tree)], 5))
    clf = MLPClassifier(10, [8, 4], 0.1, configs=3)
    out.append(("classifier", [p.numel() for p in clf.parameters()], 3))
    return out


ADAM_LAYOUTS = _adam_layouts()
SLOTS_ADAM = _build.SMS * adam_kernel.GRID_BLOCKS_PER_SM


def _check_adam_plan(sizes, folds, chunk=adam_kernel.CHUNK):
    """The chunks tile the buffer in order, each inside one (parameter,
    fold) run and at most ``chunk`` long, and give every element the fold
    that the expanded runs table gives it."""
    p = adam_kernel.plan(sizes, folds, chunk)
    index = adam_kernel.fold_index(p, folds)
    assert index.shape == (sum(sizes),)
    at = 0
    for c in range(p.chunks):
        start, end, fold = adam_kernel.chunk_span(p, c, chunk)
        assert start == at and 0 < end - start <= chunk
        assert (index[start:end] == fold).all()
        at = end
    assert at == sum(sizes)
    assert p.grid == max(1, min(p.chunks, SLOTS_ADAM))
    return p, index


@pytest.mark.parametrize("name,sizes,folds", ADAM_LAYOUTS,
                         ids=[layout[0] for layout in ADAM_LAYOUTS])
def test_masked_adam_runs_expand_to_the_fold_index(name, sizes, folds):
    """Expanded on the host, the runs table is the element fold index that
    MaskedAdam built on the device before the kernel, for every layout
    that constructs one; the CPU optimizer's ``_fold_of`` is that index."""
    _, index = _check_adam_plan(sizes, folds)
    old = _old_fold_of(sizes, folds)
    assert torch.equal(torch.from_numpy(index), old)
    if sum(sizes) > 5_000_000:   # PPMI's 24.75 M: the index alone here
        return
    params = [torch.zeros(folds, n // folds) for n in sizes]
    adam = MaskedAdam(params, lambda count: torch.full_like(count, 1e-4))
    assert adam._fold_of.dtype == old.dtype
    assert torch.equal(adam._fold_of, old)


def test_masked_adam_plan_at_the_cells():
    """Both cells' padded layouts at F = 10: 3.93 M and 24.75 M elements,
    16 parameters, one chunk a run of the small parameters, a full grid."""
    want = {"fused adni": (3929320, 1080), "fused ppmi": (24751470, 6150)}
    for name, sizes, folds in ADAM_LAYOUTS:
        if name in want:
            p = adam_kernel.plan(sizes, folds)
            assert (sum(sizes), p.chunks) == want[name]
            assert len(p.runs) == 16 and p.grid == SLOTS_ADAM


@settings(max_examples=200, deadline=None, database=None)
@given(st.integers(1, 12), st.lists(st.integers(0, 1000), min_size=1,
                                    max_size=8), st.integers(1, 700))
def test_masked_adam_plan_sweep(folds, runs, chunk):
    """Any runs (empty parameters and runs shorter, longer and a multiple
    of the chunk among them) at any chunk length."""
    sizes = [folds * r for r in runs]
    _, index = _check_adam_plan(sizes, folds, chunk)
    assert torch.equal(torch.from_numpy(index), _old_fold_of(sizes, folds))


def test_masked_adam_plan_refuses_a_parameter_without_the_fold_axis():
    with pytest.raises(ValueError, match="not \\[3, ...\\]"):
        adam_kernel.plan([6, 7], 3)


# ---- the fused train step's decoder route ------------------------------------

@pytest.mark.parametrize("hidden,latent", [([460, 460], 40), ([444, 444], 10),
                                           ([460, 460, 460], 10),
                                           ([648], 10), ([110], 324)],
                         ids=["adhd-h460", "h444", "3x460", "648", "z324"])
def test_wide_hidden_route_fits_where_the_one_pass_does_not(hidden, latent):
    """Three activation tiles of these widths are over a block's shared
    memory, two are under it: the plan takes the wide-hidden route."""
    assert ts.smem_bytes(hidden, latent) > _build.MAX_SMEM_BYTES
    assert ts.wide_hidden_smem_bytes(hidden, latent) <= _build.MAX_SMEM_BYTES
    assert ts.decoder_tiles(hidden, latent) == 2
    assert ts.route_of(0, 2) == ts.route_of(1, 2) == "wide_hidden"


def test_wide_hidden_route_at_the_adhd_cell():
    """-H 460 460 40: tiles of 472 floats (460 strided 8 mod 16), 244736 B
    on three tiles, 184320 B on two (the stages 46080 B, the dmean tile
    17408 B)."""
    assert ts.smem_bytes([460, 460], 40) == 4 * (11520 + 3 * 32 * 472 + 4352)
    assert ts.smem_bytes([460, 460], 40) == 244736
    assert ts.wide_hidden_smem_bytes([460, 460], 40) == 184320


@pytest.mark.parametrize("hidden,latent,smem", [([110, 110], 10, 109568),
                                                ([440, 440], 10, 232448),
                                                ([440, 440], 40, 232448)],
                         ids=["adni", "h440", "h440-z40"])
def test_one_pass_route_where_three_tiles_fit(hidden, latent, smem):
    """Widths that fit today keep the one-pass layout, at the bytes it had
    ([440, 440] fills a block to the byte)."""
    assert ts.smem_bytes(hidden, latent) == smem <= _build.MAX_SMEM_BYTES
    assert ts.decoder_tiles(hidden, latent) == 3
    assert ts.route_of(0, 3) == "fused" and ts.route_of(1, 3) == "wide"


def test_decoder_tiles_past_the_limit_and_forced():
    """652 wide (stride 664) fits neither layout, and neither does a latent
    of 328; forcing takes the asked layout where it fits; bf16 has no
    wide-hidden route."""
    limit = ts.MAX_WIDTH_FP32
    assert ts.decoder_tiles([limit], 10) == 2
    assert ts.decoder_tiles([limit + 4], 10) is None
    assert ts.decoder_tiles([110], limit // 2 + 4) is None
    assert ts.decoder_tiles([110, 110], 10, forced=2) == 2
    assert ts.decoder_tiles([460, 460], 40, forced=3) is None
    assert ts.decoder_tiles([432], 10, 16, wide_hidden=False) == 3
    assert ts.decoder_tiles([460, 460], 40, 16, wide_hidden=False) is None


@settings(max_examples=200, deadline=None, database=None)
@given(st.lists(st.integers(1, 700), min_size=1, max_size=3),
       st.integers(1, 400))
def test_decoder_tiles_sweep(hidden, latent):
    """The route is the one-pass layout exactly where its three tiles fit,
    else the wide-hidden one exactly where two fit; the wide-hidden layout
    is never larger."""
    one, two = (ts.smem_bytes(hidden, latent),
                ts.wide_hidden_smem_bytes(hidden, latent))
    assert two < one
    want = (3 if one <= _build.MAX_SMEM_BYTES
            else 2 if two <= _build.MAX_SMEM_BYTES else None)
    assert ts.decoder_tiles(hidden, latent) == want
    widest = max(hidden + [2 * latent])
    assert (want is not None) == (widest <= ts.MAX_WIDTH_FP32)


def test_select_kernel_takes_the_adhd_grid_widest_point_in_fp32():
    """-R ADHD -H 460 460 40 goes to K5 in fp32; bf16 is refused with its
    limit, and fp32 past 648 with its own."""
    adhd = build_model("cVAE_multimodal", [116, 116], [460, 460], 40, 29, 2)
    assert select_kernel(adhd, TrainConfig(combine="gpoe")) == ("single", "")
    kernel, why = select_kernel(adhd, TrainConfig(combine="gpoe",
                                                  precision="bf16"))
    assert kernel is None and "up to 432" in why and "244736 B" in why
    past = build_model("cVAE_multimodal", [116, 116], [652, 652], 40, 29, 2)
    kernel, why = select_kernel(past, TrainConfig(combine="gpoe"))
    assert kernel is None and "233472 B" in why
    assert "up to 648" in why and "shared memory" in why


@pytest.mark.parametrize("shape", CS.STEP_SHAPES, ids=lambda s: s[0])
def test_chip_smoke_step_shapes_take_their_decoder_route(shape):
    """chip_smoke.py's phase 6a shapes: the ADHD cell's step takes the
    wide-hidden route (two tiles), every other shape the one-pass
    layout."""
    name, _, hidden, _, _, _, latent, _ = shape
    want = 2 if name == "ADHD h460" else 3
    assert ts.decoder_tiles(hidden, latent) == want
    if name == "ADHD h460":
        assert (hidden, latent) == (CS.ADHD_HIDDEN, CS.ADHD_LATENT)
