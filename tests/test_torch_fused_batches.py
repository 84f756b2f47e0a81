"""The fused trainer's batch packer on the CPU: ``BatchPacker`` writes a
job's rows step-major, slab by slab, and must give bit for bit the
fold-major layout built literally here (zeros, then each fold's rows
batch by batch) with its step axis swapped to the front.

No JAX here: tests/test_torch_cuda.py imports ``fold_major_reference`` and
``packer_case`` for the same check on the card. Both files import from the
tests directory by module name (pytest puts the directory on the path), as
a ``tests`` package installed on the GPU machine shadows this one.
"""
import numpy as np
import pytest
import torch

from multi_modal_normative_modeling_tpu_torch.models import build_model
from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
from multi_modal_normative_modeling_tpu_torch.train.fused import (
    BatchPacker,
    FusedFoldTrainer,
)
from test_torch_threads import one_torch_thread  # noqa: F401

# (fold sizes, modality widths, covariate width, batch, precision, tile_b,
# source): the ADHD cell's ragged 441 rows (256 + 185); a fold shorter than
# the others by a whole batch (an all-padding batch); fp64 sources; K6's
# row and column alignment (bf16, batch 100 on tiles of 64: 128 rows,
# widths to 16); covariates of 29 under Cp 32; read-only sources, one with
# negative strides. Blocks of 256 rows x 1100 are copied by torch
# (``PARALLEL_COPY``), the rest by numpy.
CASES = {
    "ragged": ([441, 441], [116, 116], 3, 256, "fp32", None, "fp32"),
    "short_fold": ([441, 200, 441], [21, 10], 3, 256, "fp32", None, "fp32"),
    "fp64": ([300, 170], [1100, 21], 3, 256, "fp32", None, "fp64"),
    "k6_align": ([230, 150], [21, 10], 3, 100, "bf16", 64, "fp32"),
    "cov29": ([300, 170], [90, 270], 29, 128, "fp32", None, "fp32"),
    "read_only": ([300, 170], [1100, 1100], 3, 256, "fp32", None,
                  "read_only"),
}


def _source(a: np.ndarray, source: str, i: int) -> np.ndarray:
    if source == "fp64":
        return a
    a = a.astype(np.float32)
    if source == "read_only":
        if i % 2:
            a = np.ascontiguousarray(a[::-1])[::-1]
        a.flags.writeable = False
    return a


def packer_case(sizes, dims, c_dim, batch, precision, tile_b, source,
                seed=0):
    """(trainer, per-fold data, per-fold covariates) of one case; the
    trainer's model is a small one of the case's widths on the CPU."""
    model = build_model("cVAE_multimodal", dims, [6], 3, c_dim, len(dims),
                        folds=len(sizes),
                        generator=torch.Generator().manual_seed(0))
    config = TrainConfig(epochs=1, batch_size=batch, precision=precision)
    trainer = FusedFoldTrainer(model, config, max(sizes), tile_b=tile_b)
    rng = np.random.default_rng(seed)
    data = [[_source(rng.standard_normal((n, d)), source, i)
             for i, d in enumerate(dims)] for n in sizes]
    cov = [_source(rng.standard_normal((n, c_dim)), source, 0)
           for n in sizes]
    return trainer, data, cov


def fold_major_reference(step, data, cov, batch_size) -> dict:
    """The layout built fold-major, zeros first and each fold's rows batch
    by batch, then swapped step-major: x [NB, F, M, Bp, Dp], c [NB, F, Bp,
    Cp], rm [NB, F, Bp], nvalid [NB, F], valid [NB, F]."""
    folds = len(data)
    nb = max(1, -(-max(d[0].shape[0] for d in data) // batch_size))
    bp = -(-batch_size // step.row_align) * step.row_align
    x = np.zeros((folds, nb, step.model.modalities, bp, step.Dp), np.float32)
    c = np.zeros((folds, nb, bp, step.Cp), np.float32)
    rm = np.zeros((folds, nb, bp), np.float32)
    counts = np.zeros((folds, nb), np.float32)
    for f in range(folds):
        n = data[f][0].shape[0]
        for b in range(nb):
            lo, hi = b * batch_size, min(n, (b + 1) * batch_size)
            if hi <= lo:
                continue
            for m, d in enumerate(data[f]):
                x[f, b, m, :hi - lo, :d.shape[1]] = d[lo:hi]
            c[f, b, :hi - lo, :cov[f].shape[1]] = cov[f][lo:hi]
            rm[f, b, :hi - lo] = 1.0
            counts[f, b] = hi - lo
    step_major = {"x": x, "c": c, "rm": rm,
                  "nvalid": np.maximum(counts, 1.0), "valid": counts > 0}
    return {k: np.ascontiguousarray(np.swapaxes(v, 0, 1))
            for k, v in step_major.items()}


def _assert_same(got: dict, want: dict):
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert np.array_equal(got[k], v), k


@pytest.mark.parametrize("case", list(CASES))
def test_packer_writes_the_fold_major_layout_step_major(case):
    trainer, data, cov = packer_case(*CASES[case])
    batch = trainer.config.batch_size
    packer = BatchPacker(trainer.step, data, cov, batch)
    x, c = packer.pack_all()
    want = fold_major_reference(trainer.step, data, cov, batch)
    _assert_same(dict(x=x.numpy(), c=c.numpy(), **packer.meta()), want)
    if case == "short_fold":
        assert not want["valid"][1, 1] and want["nvalid"][1, 1] == 1.0
    if case == "k6_align":
        assert x.shape[3:] == (128, 32) and c.shape[3] == 16
    if case == "read_only":
        assert [v is None for v in packer.views[0]] == [False, True]


@pytest.mark.parametrize("case", list(CASES))
def test_a_reused_slab_keeps_nothing_of_the_job_before(case):
    """Two slabs of zeros, as the card's ring makes them, take a larger
    job's steps in turn (300 more rows in every fold, each modality as wide
    as the padded width), then the case's own steps: they read as the
    case's layout, and ``written`` holds what the case's step filled."""
    sizes, dims, *rest = CASES[case]
    trainer, data, cov = packer_case(sizes, dims, *rest)
    batch, dp = trainer.config.batch_size, trainer.step.Dp
    rng = np.random.default_rng(1)
    big = BatchPacker(trainer.step, [
        [rng.standard_normal((n + 300, dp)) for _ in dims] for n in sizes],
        [rng.standard_normal((n + 300, cov[0].shape[1])) for n in sizes],
        batch)
    packer = BatchPacker(trainer.step, data, cov, batch)
    assert big.slab_shapes == packer.slab_shapes
    want = fold_major_reference(trainer.step, data, cov, batch)
    ring = [tuple(torch.zeros(s) for s in packer.slab_shapes)
            + (packer.nothing_written(),) for _ in range(2)]
    for t in range(big.n_batches):
        big.pack(t, *ring[t % 2])
    for t in range(packer.n_batches):
        x, c, written = ring[t % 2]
        packer.pack(t, x, c, written)
        assert np.array_equal(x.numpy(), want["x"][t]), t
        assert np.array_equal(c.numpy(), want["c"][t]), t
        filled = np.array(written)
        assert np.array_equal(filled[..., 0], np.repeat(
            packer.counts[t][:, None], len(dims) + 1, axis=1))
        assert np.array_equal(filled[..., 1], np.tile(
            dims + [cov[0].shape[1]], (len(sizes), 1)))


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_batches_on_the_cpu_are_the_reference_layout(case):
    """``FusedFoldTrainer.batches`` on the CPU: every attribute the step
    loop reads, x and c in the step's storage dtype (bf16 under K6); no
    slab goes through the card's ring."""
    trainer, data, cov = packer_case(*CASES[case])
    batches = trainer.batches(data, cov, "cpu")
    want = fold_major_reference(trainer.step, data, cov,
                                trainer.config.batch_size)
    stored = trainer.step.cast_batch({k: torch.from_numpy(want[k])
                                      for k in ("x", "c")})
    for k in ("x", "c"):
        assert torch.equal(getattr(batches, k), stored[k]), k
    assert batches.x.dtype == (torch.bfloat16 if case == "k6_align"
                               else torch.float32)
    for k in ("rm", "nvalid"):
        assert torch.equal(getattr(batches, k), torch.from_numpy(want[k])), k
    assert batches.mask is batches.rm
    assert np.array_equal(batches.valid_host, want["valid"])
    assert torch.equal(batches.valid,
                       torch.from_numpy(want["valid"].astype(np.float32)))
    assert (batches.n_batches, batches.folds, batches.rows) == want["rm"].shape
    step = batches.step(batches.n_batches - 1)
    assert torch.equal(step["x"], batches.x[-1])
    assert torch.equal(step["nvalid"], batches.nvalid[-1])
    assert trainer.staging_counts == {"slabs": 0, "allocations": 0}
