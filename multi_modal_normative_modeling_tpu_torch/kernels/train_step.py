"""The fused cVAE train step (K5): the CUDA kernels and their plain version.

``FusedTrainStep`` replaces the Pallas kernel
``multi_modal_normative_modeling_tpu/kernels/train_step.py::_kernel`` (via
``FusedTrainStep.loss_and_grads_padded``): one whole training step of the
packed cVAE, forward and hand-derived backward (the math of the JAX file's
header), for every fold at once: M encoders, fusion (poe, gpoe, moe or
mopoe, with the M == 1 shortcut), z = mu + eps * exp(lgv / 2), M decoders,
the masked ELBO, then every parameter gradient, dalpha included.

A CUDA tensor goes to ``csrc/train_step.cu``; a CPU tensor goes to the plain
version, torch autograd over ``models.stacked`` forward and loss
(``FusedTrainStep.reference``), which is what the JAX package's own kernel
tests hold its kernel against. ``fused_train_step.launches`` counts the
steps run on the card.

Layout. The kernel works on the packed tree of ``models.stacked`` with a
leading fold axis and nothing else padded: ``pad_params`` only names and
flattens it (weights [F, M, in, out], biases [F, M, out], alpha [F, M]),
``unpad_named`` rebuilds the tree, and their gradients are the contract.
The TPU's 128-lane and 8-sublane rounding has no counterpart here; padded
feature columns (a modality narrower than d_max) are masked by the
modality's width, carry zero weights and get exactly zero gradients.
Batches are x [F, M, B, d_max], c [F, B, C], eps [F, B, Z], the row mask
[F, B] and n = max(sum(mask), 1) [F].

``StepFunction`` puts the step under autograd for the trainers' epoch loop:
its forward runs the step (losses and every gradient), its backward scales
the stored gradients by the incoming one.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from . import _build

COMBINES = ("poe", "gpoe", "moe", "mopoe")
MAX_HIDDEN = 3   # csrc/train_step.cu's MAX_L
MAX_MODALITIES = 8

# csrc/train_step.cu's tile constants: TM rows per block of the row-owned
# passes, BN columns and BK depth per product pass
TM, BN, BK = 32, 64, 32
_STAGE_FLOATS = TM * (BK + 1) + BK * (BN + 1)


def smem_bytes(hidden) -> int:
    """Dynamic shared memory of the step's largest block (the decoder pass:
    the product stage, three activation tiles of the widest hidden layer, a
    dmean tile and a mean-head weight chunk of the last decoder width)."""
    widest = max(hidden)
    return 4 * (_STAGE_FLOATS + 3 * TM * widest + TM * (BN + 1)
                + BN * hidden[0])


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _work_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions compute in fp32, or in fp64 for fp64 inputs."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


class FusedTrainStep:
    """The fused step of one ``StackedMultimodalCVAE`` (variant cvae, fp32,
    LeakyReLU, 1 to 3 hidden layers) under one fusion."""

    # batch-axis padding multiple (the tiled subclass raises it to tile_b)
    row_align: int = 1
    compute_dtype = torch.float32

    def __init__(self, stacked_model, combine: str):
        from ..models.stacked import StackedMultimodalCVAE

        if not isinstance(stacked_model, StackedMultimodalCVAE):
            raise TypeError("FusedTrainStep takes a StackedMultimodalCVAE")
        self.model = stacked_model
        self.combine = combine.lower()
        if self.combine not in COMBINES:
            raise NotImplementedError(f"fusion {combine!r}")
        m = stacked_model
        if not m.non_linear:
            raise NotImplementedError("the fused step runs LeakyReLU layers")
        if m.n_hidden > MAX_HIDDEN:
            raise NotImplementedError(f"{m.n_hidden} hidden layers; the "
                                      f"kernel takes 1 to {MAX_HIDDEN}")
        if m.modalities > MAX_MODALITIES:
            raise NotImplementedError(f"{m.modalities} modalities; the "
                                      f"kernel takes up to {MAX_MODALITIES}")
        self.M, self.L = m.modalities, m.n_hidden
        self.Z, self.C, self.D = m.latent_dim, m.c_dim, m.d_max
        self.H = list(m.hidden_dim)
        self.Hr = self.H[::-1]           # decoder hidden widths, in order
        self._shapes = self._param_shapes()
        self._param_names = list(self._shapes)
        self._workspace: Dict[tuple, torch.Tensor] = {}

    # ---- layout ---------------------------------------------------------------
    def _param_shapes(self) -> Dict[str, tuple]:
        """Per-fold shapes of the named layout; alpha comes last (the
        kernel's weight-gradient pass covers every name before it)."""
        M, L, Z, C, D = self.M, self.L, self.Z, self.C, self.D
        shapes = {}
        k = D + C
        for l in range(L):
            shapes[f"enc_w{l}"] = (M, k, self.H[l])
            shapes[f"enc_b{l}"] = (M, self.H[l])
            k = self.H[l]
        shapes.update(wmu=(M, k, Z), bmu=(M, Z), wlv=(M, k, Z), blv=(M, Z))
        k = Z + C
        for l in range(L):
            shapes[f"dec_w{l}"] = (M, k, self.Hr[l])
            shapes[f"dec_b{l}"] = (M, self.Hr[l])
            k = self.Hr[l]
        shapes.update(vm=(M, k, D), cm=(M, D), lvo=(M, D), alpha=(M,))
        return shapes

    def pad_params(self, packed: dict) -> Dict[str, torch.Tensor]:
        """The packed tree -> the named kernel layout (contiguous)."""
        e, d = packed["enc"], packed["dec"]
        out = {}
        for l in range(self.L):
            out[f"enc_w{l}"] = e["layers"][l]["w"]
            out[f"enc_b{l}"] = e["layers"][l]["b"]
        out.update(wmu=e["wmu"], bmu=e["bmu"], wlv=e["wlv"], blv=e["blv"])
        for l in range(self.L):
            out[f"dec_w{l}"] = d["layers"][l]["w"]
            out[f"dec_b{l}"] = d["layers"][l]["b"]
        out.update(vm=d["wm"], cm=d["bm"], lvo=d["lvo"],
                   alpha=packed["alpha"])
        return {k: out[k].contiguous() for k in self._param_names}

    def unpad_named(self, g: Dict[str, torch.Tensor]) -> dict:
        """Named layout (params or gradients) -> the packed tree."""
        L = self.L
        return {
            "alpha": g["alpha"],
            "enc": {
                "layers": [{"w": g[f"enc_w{l}"], "b": g[f"enc_b{l}"]}
                           for l in range(L)],
                "wmu": g["wmu"], "bmu": g["bmu"],
                "wlv": g["wlv"], "blv": g["blv"],
            },
            "dec": {
                "layers": [{"w": g[f"dec_w{l}"], "b": g[f"dec_b{l}"]}
                           for l in range(L)],
                "wm": g["vm"], "bm": g["cm"], "lvo": g["lvo"],
            },
        }

    def pack_batch(self, x_packed: torch.Tensor, c: torch.Tensor,
                   rowmask: torch.Tensor):
        """x_packed [F, M, B, d_max], c [F, B, C], rowmask [F, B] ->
        (x, c, rm, nvalid) with B padded to ``row_align``."""
        B = x_packed.shape[2]
        pad = _round_up(B, self.row_align) - B
        x = torch.nn.functional.pad(x_packed.float(), (0, 0, 0, pad))
        c = torch.nn.functional.pad(c.float(), (0, 0, 0, pad))
        rm = torch.nn.functional.pad(rowmask.float(), (0, pad))
        nvalid = torch.clamp(rowmask.float().sum(-1), min=1.0)
        return x.contiguous(), c.contiguous(), rm.contiguous(), nvalid

    def pad_eps(self, eps: torch.Tensor) -> torch.Tensor:
        """[F, B, Z] -> [F, Bp, Z]: the noise stream is drawn [B, Z] per
        fold, as the trainers draw it, and padded after."""
        B = eps.shape[1]
        pad = _round_up(B, self.row_align) - B
        if pad == 0:
            return eps.contiguous()
        return torch.nn.functional.pad(eps, (0, 0, 0, pad))

    def cast_exec(self, named: Dict[str, torch.Tensor]):
        """Execution copy of the parameters (identity in fp32)."""
        return named

    def cast_batch(self, batch: dict) -> dict:
        """Storage-dtype batch (identity in fp32)."""
        return batch

    # ---- the step ----------------------------------------------------------------
    def reference(self, named, x, c, eps, rm, nvalid):
        """The plain version: autograd over the stacked model's forward and
        loss (``nvalid`` is max(sum(rm), 1), which the loss recomputes). It
        computes in fp32, or in fp64 when x is fp64."""
        work = _work_dtype(x)
        with torch.enable_grad():
            leaves = {k: v.detach().to(work).requires_grad_()
                      for k, v in named.items()}
            packed = self.unpad_named(leaves)
            fwd = self.model.forward(packed, x.to(work), c.to(work),
                                     self.combine, eps.to(work))
            losses = self.model.loss(packed, x.to(work), fwd, rm.to(work))
            grads = torch.autograd.grad(losses["total"].sum(),
                                        list(leaves.values()),
                                        allow_unused=True)
        out = {k: torch.zeros_like(leaves[k]) if g is None else g
               for k, g in zip(leaves, grads)}
        return {k: v.detach() for k, v in losses.items()}, out

    def loss_and_grads_padded(self, named, x, c, eps, rm, nvalid):
        """(losses {total, kl, ll: [F]}, gradients in the named layout)."""
        if x.device.type == "cpu":
            return self.reference(named, x, c, eps, rm, nvalid)
        if x.device.type != "cuda":
            raise ValueError(f"fused_train_step: no kernel for {x.device}")
        return fused_train_step(self, named, x, c, eps, rm, nvalid)

    def loss_and_grads(self, packed: dict, x_packed, c, eps, rowmask):
        """Compat path (layouts per call): returns (losses, packed grads)."""
        named = self.pad_params(packed)
        x, cc, rm, nvalid = self.pack_batch(x_packed, c, rowmask)
        losses, grads = self.loss_and_grads_padded(
            named, x, cc, self.pad_eps(eps), rm, nvalid)
        return losses, self.unpad_named(grads)

    def loss_fn(self, params: List[torch.Tensor]):
        """``loss_fn(batch, eps) -> (total [F], logs)`` over ``params`` (the
        named layout, in ``_param_names`` order) for train.trainer's epoch
        loop; batch holds x, c, rm, nvalid in kernel layout."""
        step = self

        def fn(batch, eps):
            total, kl, ll = StepFunction.apply(
                step, batch["x"], batch["c"], step.pad_eps(eps), batch["rm"],
                batch["nvalid"], *params)
            return total, {"total": total, "kl": kl, "ll": ll}

        return fn


class StepFunction(torch.autograd.Function):
    """Losses by the fused step; the gradient of any function of ``total``
    is the stored parameter gradients times its cotangent, per fold."""

    @staticmethod
    def forward(ctx, step, x, c, eps, rm, nvalid, *params):
        named = dict(zip(step._param_names, params))
        losses, grads = step.loss_and_grads_padded(named, x, c, eps, rm,
                                                   nvalid)
        ctx.grads = [grads[k] for k in step._param_names]
        ctx.mark_non_differentiable(losses["kl"], losses["ll"])
        return losses["total"], losses["kl"], losses["ll"]

    @staticmethod
    def backward(ctx, g_total, _g_kl, _g_ll):
        out = []
        for g in ctx.grads:
            out.append(g * g_total.reshape((-1,) + (1,) * (g.dim() - 1)))
        ctx.grads = None
        return (None,) * 6 + tuple(out)


# ---- the CUDA launch ------------------------------------------------------------

def _check(step: FusedTrainStep, named, x, c, eps, rm, nvalid, dtype):
    name = "fused_train_step"
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be [F, M, B, d_max], got "
                         f"{tuple(x.shape)}")
    folds, m, rows, d = x.shape
    if (m, d) != (step.M, step.D):
        raise ValueError(f"{name}: x has shape {tuple(x.shape)}, expected "
                         f"[F, {step.M}, B, {step.D}]")
    for t, what, want in ((c, "c", (folds, rows, step.C)),
                          (eps, "eps", (folds, rows, step.Z)),
                          (rm, "rm", (folds, rows)),
                          (nvalid, "nvalid", (folds,))):
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, "
                             f"expected {list(want)}")
    for k, shape in step._shapes.items():
        t = named[k]
        if tuple(t.shape) != (folds,) + shape:
            raise ValueError(f"{name}: {k} has shape {tuple(t.shape)}, "
                             f"expected {[folds, *shape]}")
    stored = [x, c] + [named[k] for k in step._param_names
                       if _is_matmul_param(k)]
    fp32 = [eps, rm, nvalid] + [named[k] for k in step._param_names
                                if not _is_matmul_param(k)]
    for t in stored + fp32:
        if t.device != x.device:
            raise ValueError(f"{name}: operand on {t.device}, expected "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    for t in stored:
        if t.dtype != dtype:
            raise ValueError(f"{name}: operand dtype {t.dtype}, expected "
                             f"{dtype}")
    for t in fp32:
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: operand dtype {t.dtype}, expected "
                             "torch.float32")
    smem = smem_bytes(step.H)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"{name}: hidden widths {step.H} need {smem} B of "
                         f"shared memory, over the {_build.MAX_SMEM_BYTES} B "
                         "limit")
    return folds, rows


# weight tensors stored in the compute dtype on the bf16 path; biases, lvo
# and alpha stay fp32 (JAX train_step_tiled.py:63-69)
_MATMUL_PARAMS = ("enc_w", "dec_w", "wmu", "wlv", "vm")


def _is_matmul_param(name: str) -> bool:
    return name.startswith(_MATMUL_PARAMS)


def launch(step: FusedTrainStep, named, x, c, eps, rm, nvalid,
           tile_rows: int, dtype) -> Tuple[dict, dict]:
    """One step on the card: every launch of csrc/train_step.cu. Weight
    gradients sum their rows in groups of ``tile_rows`` (partials summed in
    group order when there is more than one group)."""
    folds, rows = _check(step, named, x, c, eps, rm, nvalid, dtype)
    ints = [folds, step.M, rows, step.L, step.Z, step.C, step.D,
            COMBINES.index(step.combine), tile_rows]
    ints += list(step.model.input_dim_list) + step.H
    ints_c = (ctypes.c_int * len(ints))(*ints)
    lib = _build.load_library()
    bf16 = int(dtype == torch.bfloat16)
    key = (tuple(ints), bf16, x.device)
    work = step._workspace.get(key)
    if work is None:
        nbytes = lib.mmnm_train_step_workspace(ints_c, bf16)
        if nbytes < 0:
            raise ValueError(f"fused_train_step: shapes {ints} refused by "
                             "the kernel")
        work = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                           device=x.device)
        step._workspace = {key: work}
    sizes = [folds * _numel(step._shapes[k]) for k in step._param_names]
    flat = torch.empty(sum(sizes) + 3 * folds, device=x.device)
    grads = {k: v.view((folds,) + step._shapes[k]) for k, v in zip(
        step._param_names, flat[:sum(sizes)].split(sizes))}
    losses = flat[sum(sizes):].view(folds, 3)
    ptrs = ([x, c, eps, rm, nvalid]
            + [named[k] for k in step._param_names]
            + [grads[k] for k in step._param_names] + [losses])
    ptrs_c = (ctypes.c_void_p * (len(ptrs) + 1))(
        *[t.data_ptr() for t in ptrs], work.data_ptr())
    with torch.cuda.device(x.device):
        rc = lib.mmnm_train_step(ptrs_c, ints_c, bf16,
                                 _build.stream_of(x.device))
    _build.check_launch(lib, rc, "fused_train_step")
    return {"total": losses[:, 0], "kl": losses[:, 1],
            "ll": losses[:, 2]}, grads


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def fused_train_step(step: FusedTrainStep, named, x, c, eps, rm, nvalid):
    """K5 on the card: one step with the weight-gradient sums over the whole
    batch. ``launches`` counts the steps."""
    out = launch(step, named, x, c, eps, rm, nvalid, x.shape[2],
                 torch.float32)
    fused_train_step.launches += 1
    return out


fused_train_step.launches = 0
