"""The port's fused train step (K5) and batch-tiled step (K6) against the JAX
package's, on the CPU.

On CPU tensors the port runs the plain versions: autograd over the packed
model for FusedTrainStep, the torch transcription of the tile loop for
TiledFusedTrainStep. JAX runs its Pallas kernels with interpret=True, as
its own tests do, on the same numpy-seeded problems
(tests/test_train_step_kernel.py, tests/test_train_step_tiled.py). Bounds
are theirs: total rtol 1e-5, gradients rtol 1e-3 / atol 1e-5; tiled against
single-block rtol 1e-4 / atol 1e-6; bf16 against fp32 autodiff a total
within 2e-2 and a normalized error per gradient leaf under 6e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_normative_modeling_tpu.kernels.train_step import (
    FusedTrainStep as JaxStep,
)
from multi_modal_normative_modeling_tpu.kernels.train_step_tiled import (
    TiledFusedTrainStep as JaxTiled,
)
from multi_modal_normative_modeling_tpu_torch.kernels import _build
from multi_modal_normative_modeling_tpu_torch.kernels.train_step import (
    FusedTrainStep,
    smem_bytes,
)
from multi_modal_normative_modeling_tpu_torch.kernels.train_step_tiled import (
    TiledFusedTrainStep,
)
from multi_modal_normative_modeling_tpu_torch.models.stacked import (
    StackedMultimodalCVAE,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_train_step_kernel import _make_problem, _reference_loss
from tests.test_train_step_tiled import _problem as _tiled_problem

C, Z = 5, 6


def _port(jmodel, combine, cls=FusedTrainStep, **kw):
    stacked = StackedMultimodalCVAE(jmodel.input_dim_list, jmodel.hidden_dim,
                                    jmodel.latent_dim, jmodel.c_dim,
                                    jmodel.modalities)
    return cls(stacked, combine, **kw)


def _fold(tree):
    """A JAX array tree -> torch tensors with a fold axis of 1."""
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32))[None], tree)


def _port_call(step, params, xp, c, eps, rowmask):
    return step.loss_and_grads(
        _fold(params), _fold(xp), _fold(c), _fold(eps), _fold(rowmask))


def _close(grads, ref, **tol):
    got = jax.tree_util.tree_leaves(grads)
    want = jax.tree_util.tree_leaves(ref)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), **tol)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


CASES = {
    "gpoe": ([12, 12], [24, 40, 16], "gpoe"),
    "poe": ([12, 12], [24, 40, 16], "poe"),
    "moe": ([12, 12], [24, 40, 16], "moe"),
    "mopoe": ([12, 12], [24, 40, 16], "mopoe"),
    "1hidden": ([14], [24, 40, 16], "gpoe"),
    "3hidden": ([20, 12, 8], [24, 40, 16], "gpoe"),
    "1modality": ([12, 12], [30], "gpoe"),
    # no width a multiple of 4 anywhere (C 5 and Z 6 neither): every tensor
    # of the padded layout is wider than its true shape
    "ragged": ([13, 10], [37, 9, 22], "gpoe"),
    "ragged-mopoe": ([11], [21, 6], "mopoe"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_step_matches_jax_kernel(case):
    hidden, dims, combine = CASES[case]
    model, params, xp, c, eps, rowmask = _make_problem(hidden, dims, seed=2)
    ref_losses, ref_grads = JaxStep(model, combine, interpret=True) \
        .loss_and_grads(params, xp, c, eps, rowmask)
    losses, grads = _port_call(_port(model, combine), params, xp, c, eps,
                               rowmask)
    for k in ("total", "kl", "ll"):
        np.testing.assert_allclose(losses[k][0].item(), float(ref_losses[k]),
                                   rtol=1e-5)
    _close(grads, ref_grads, rtol=1e-3, atol=1e-5)


def test_fused_step_matches_jax_autodiff_with_two_folds():
    """Two folds in one call (the second with every row valid), each
    against jax.grad of the stacked model."""
    model, params, xp, c, eps, rowmask = _make_problem([12, 12])
    masks = [rowmask, jnp.ones_like(rowmask)]
    step = _port(model, "gpoe")
    two = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.stack([np.asarray(a)] * 2)),
        (params, xp, c, eps))
    losses, grads = step.loss_and_grads(
        *two, torch.from_numpy(np.stack([np.asarray(m) for m in masks])))
    for f, mask in enumerate(masks):
        total, ref = jax.value_and_grad(_reference_loss(
            model, xp, c, eps, mask, "gpoe"))(params)
        np.testing.assert_allclose(losses["total"][f].item(), float(total),
                                   rtol=1e-5)
        for a, b in zip(jax.tree_util.tree_leaves(grads),
                        jax.tree_util.tree_leaves(ref)):
            np.testing.assert_allclose(a[f].numpy(), np.asarray(b),
                                       rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("case", ["gpoe", "mopoe", "3hidden", "1modality"])
def test_tiled_fp32_matches_jax_tiled(case):
    """tile 8 over 20 rows (three tiles) against JAX's tiled kernel; the
    last tile is all padding (tests/test_train_step_tiled.py:108-123)."""
    hidden, dims, combine = CASES[case]
    model, params, xp, c, eps, _ = _tiled_problem(hidden, dims, seed=1)
    rowmask = jnp.asarray(np.r_[np.ones(10), np.zeros(10)].astype(
        np.float32))
    ref_losses, ref_grads = JaxTiled(model, combine, tile_b=8,
                                     interpret=True).loss_and_grads(
        params, xp, c, eps, rowmask)
    step = _port(model, combine, TiledFusedTrainStep, tile_b=8)
    losses, grads = _port_call(step, params, xp, c, eps, rowmask)
    np.testing.assert_allclose(losses["total"][0].item(),
                               float(ref_losses["total"]), rtol=1e-5)
    _close(grads, ref_grads, rtol=1e-4, atol=1e-6)
    # the tile loop equals the autograd plain version (the single step)
    single = _port_call(_port(model, combine), params, xp, c, eps, rowmask)
    for a, b in zip(jax.tree_util.tree_leaves(grads),
                    jax.tree_util.tree_leaves(single[1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)


def test_tiled_bf16_matches_jax_bf16_and_tracks_fp32():
    """bf16 operands with fp32 accumulation: against JAX's bf16 tiled
    kernel (same cast points), and within bf16 distance of fp32 autodiff
    (tests/test_train_step_tiled.py:126-146)."""
    model, params, xp, c, eps, rowmask = _tiled_problem([12, 12], seed=4)
    ref_total, ref_grads = jax.value_and_grad(_reference_loss(
        model, xp, c, eps, rowmask, "gpoe"))(params)
    jax_losses, jax_grads = JaxTiled(
        model, "gpoe", tile_b=16, compute_dtype=jnp.bfloat16,
        interpret=True).loss_and_grads(params, xp, c, eps, rowmask)
    step = _port(model, "gpoe", TiledFusedTrainStep, tile_b=16,
                 compute_dtype=torch.bfloat16)
    losses, grads = _port_call(step, params, xp, c, eps, rowmask)
    total = losses["total"][0].item()
    assert abs(total - float(ref_total)) / abs(float(ref_total)) < 2e-2
    np.testing.assert_allclose(total, float(jax_losses["total"]), rtol=1e-4)
    for got, want, bf in zip(jax.tree_util.tree_leaves(grads),
                             jax.tree_util.tree_leaves(ref_grads),
                             jax.tree_util.tree_leaves(jax_grads)):
        assert _rel(got[0].numpy(), want) < 6e-2
        assert _rel(got[0].numpy(), bf) < 1e-2


def test_bf16_cast_exec_casts_only_matmul_weights():
    stacked = StackedMultimodalCVAE([24, 16], [12, 12], Z, C, 2)
    step = TiledFusedTrainStep(stacked, "gpoe", tile_b=16,
                               compute_dtype=torch.bfloat16)
    named = {k: torch.zeros((1,) + s) for k, s in step._shapes.items()}
    for k, v in step.cast_exec(named).items():
        want = (torch.bfloat16 if k.startswith(
            ("enc_w", "dec_w", "wmu", "wlv", "vm")) else torch.float32)
        assert v.dtype == want, k
    batch = step.cast_batch({"x": torch.zeros(1), "c": torch.zeros(1),
                             "rm": torch.zeros(1)})
    assert batch["x"].dtype == batch["c"].dtype == torch.bfloat16
    assert batch["rm"].dtype == torch.float32


def test_step_function_returns_the_steps_gradients():
    """Autograd through StepFunction (the trainers' path) gives the step's
    gradients times the cotangent of each fold's total."""
    model, params, xp, c, eps, rowmask = _make_problem([12, 12])
    step = _port(model, "moe")
    named = step.pad_params(_fold(params))
    x, cc, rm, nvalid = step.pack_batch(_fold(xp), _fold(c), _fold(rowmask))
    leaves = [torch.nn.Parameter(named[k].clone())
              for k in step._param_names]
    total, logs = step.loss_fn(leaves)(
        {"x": x, "c": cc, "rm": rm, "nvalid": nvalid}, _fold(eps))
    grads = torch.autograd.grad(3.0 * total.sum(), leaves)
    ref_losses, ref_grads = step.loss_and_grads_padded(
        named, x, cc, _fold(eps), rm, nvalid)
    assert torch.equal(logs["kl"], ref_losses["kl"])
    for k, g in zip(step._param_names, grads):
        torch.testing.assert_close(g, 3.0 * ref_grads[k])


def test_shared_memory_limit_and_scope():
    assert smem_bytes([110, 110]) <= _build.MAX_SMEM_BYTES
    assert smem_bytes([3485]) > _build.MAX_SMEM_BYTES
    stacked = StackedMultimodalCVAE([24], [12] * 4, Z, C, 1)
    with pytest.raises(NotImplementedError, match="hidden layers"):
        FusedTrainStep(stacked, "gpoe")
    with pytest.raises(NotImplementedError, match="fusion"):
        FusedTrainStep(StackedMultimodalCVAE([24], [12], Z, C, 1), "sum")
    step = TiledFusedTrainStep(StackedMultimodalCVAE([24], [12], Z, C, 1),
                               "gpoe", batch_hint=100)
    assert step.tile_b == 100 and step.row_align == 100


def _named_problem(hidden, dims, combine, cls=FusedTrainStep, **kw):
    model, params, xp, c, eps, rowmask = _make_problem(hidden, dims, seed=3)
    step = _port(model, combine, cls, **kw)
    packed = _fold(params)
    named = step.pad_params(packed)
    x, cc, rm, nvalid = step.pack_batch(_fold(xp), _fold(c), _fold(rowmask))
    return step, packed, named, (x, cc, step.pad_eps(_fold(eps)), rm, nvalid)


@pytest.mark.parametrize("cls,kw,align", [
    (FusedTrainStep, {}, 4),
    (TiledFusedTrainStep, dict(tile_b=8), 4),
    (TiledFusedTrainStep, dict(tile_b=8, compute_dtype=torch.bfloat16), 16)],
    ids=["k5", "k6-fp32", "k6-bf16"])
def test_padded_layout_round_trips(cls, kw, align):
    """pad_params then unpad_named is the identity; every padded width is a
    multiple of the alignment (4 in fp32, 16 in bf16), the [x | c]
    and [z | c] blocks each on their own; the padding is zero."""
    step, packed, named, batch = _named_problem([13, 10], [37, 9, 22],
                                                "gpoe", cls, **kw)
    assert step.col_align == align
    assert (step.Dp, step.Cp, step.Zp, step.Hp) == tuple(
        -(-n // align) * align if isinstance(n, int)
        else [-(-h // align) * align for h in n]
        for n in (37, C, Z, [13, 10]))
    for k, t in named.items():
        assert tuple(t.shape[1:]) == step._shapes[k] and t.is_contiguous()
        if k != "alpha":
            assert all(n % align == 0 for n in t.shape[2:]), k
    assert named["enc_w0"].shape[2] == step.Dp + step.Cp
    assert named["dec_w0"].shape[2] == step.Zp + step.Cp
    # the covariate rows start at the padded d_max / latent width
    torch.testing.assert_close(
        named["enc_w0"][:, :, step.Dp:step.Dp + C, :13],
        packed["enc"]["layers"][0]["w"][:, :, 37:], rtol=0, atol=0)
    torch.testing.assert_close(
        named["dec_w0"][:, :, step.Zp:step.Zp + C, :10],
        packed["dec"]["layers"][0]["w"][:, :, Z:], rtol=0, atol=0)
    back = step.unpad_named(named)
    want = jax.tree_util.tree_leaves(packed)
    got = jax.tree_util.tree_leaves(back)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    total = sum(t.sum().item() for t in named.values())
    assert total == pytest.approx(sum(t.sum().item() for t in want), rel=1e-5)
    x, cc = batch[0], batch[1]
    assert x.shape[-1] == step.Dp and cc.shape[-1] == step.Cp
    assert torch.count_nonzero(x[..., 37:]) == 0
    assert torch.count_nonzero(cc[..., C:]) == 0
    widened = step.widen(step.strip(named))
    assert all(torch.equal(widened[k], named[k]) for k in named)


def test_padded_gradients_are_zero_and_flat_matches_named():
    """The plain version's gradients in the padded layout: zero in every
    padded entry, and the flat buffer is the named gradients back to back
    in _param_names order."""
    step, _, named, batch = _named_problem([13, 10], [37, 9, 22], "gpoe")
    losses, grads = step.loss_and_grads_padded(named, *batch)
    ones = step.widen({k: torch.ones_like(v)
                       for k, v in step.strip(named).items()})
    for k, g in grads.items():
        assert g.shape == named[k].shape
        assert torch.count_nonzero(g[ones[k] == 0]) == 0, k
        assert torch.count_nonzero(g) > 0, k
    losses2, flat = step.loss_and_grads_flat(named, *batch)
    assert torch.equal(losses["total"], losses2["total"])
    assert torch.equal(flat, torch.cat([grads[k].reshape(-1)
                                        for k in step._param_names]))
