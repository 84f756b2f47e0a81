"""The fused cVAE train step (K5): the CUDA kernels and their plain version.

``FusedTrainStep`` replaces the Pallas kernel
``multi_modal_normative_modeling_tpu/kernels/train_step.py::_kernel`` (via
``FusedTrainStep.loss_and_grads_padded``): one whole training step of the
packed cVAE, forward and hand-derived backward (the math of the JAX file's
header), for every fold at once: M encoders, fusion (poe, gpoe, moe or
mopoe, with the M == 1 shortcut), z = mu + eps * exp(lgv / 2), M decoders,
the masked ELBO, then every parameter gradient, dalpha included.

A CUDA tensor goes to ``csrc/train_step.cuh``; a CPU tensor goes to the plain
version, torch autograd over ``models.stacked`` forward and loss
(``FusedTrainStep.reference``), which is what the JAX package's own kernel
tests hold its kernel against. ``fused_train_step.launches`` counts the
steps run on the card.

Layout. The kernel works on the packed tree of ``models.stacked`` with a
leading fold axis, flattened to named tensors (weights [F, M, in, out],
biases [F, M, out], alpha [F, M]) whose widths are padded to a multiple of
``col_align`` elements (4 in fp32; 16 in bf16, one k16 step of the tensor
cores' mma): d_max, every hidden width,
and the latent and covariate blocks of the [x | c] and [z | c] inputs each
on their own, so that every row of every operand starts on a 16-byte
boundary and the kernel brings its tiles in with 16-byte asynchronous
copies. ``pad_params`` builds that layout (padded entries zero),
``unpad_named`` cuts it back to the packed tree, and the gradients come in
the same layout: padded entries get exactly zero gradients, so an optimizer
that starts them at zero keeps them there. The TPU's 128-lane and 8-sublane
rounding has no counterpart here. Batches are x [F, M, B, d_max padded],
c [F, B, C padded], eps [F, B, Z], the row mask [F, B] and
n = max(sum(mask), 1) [F]. The kernel writes every gradient into one flat
fp32 buffer, back to back in ``_param_names`` order; the named gradients
are views of it, and ``loss_and_grads_flat`` hands the buffer itself to an
optimizer that keeps its parameters in the same order.

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
MAX_HIDDEN = 3   # csrc/train_step.cuh's MAX_L
MAX_MODALITIES = 8

# csrc/train_step.cuhh's tile constants: TM rows per block of the row-owned
# passes, BN columns and BK depth per product pass, two stages of an A tile
# and a weight tile on a stride of BK + 4
TM, BN, BK = 32, 128, 32
_STAGE_FLOATS = 2 * (TM + BN) * (BK + 4)
COL_ALIGN = 4    # elements: 16 bytes of fp32


def smem_bytes(hidden, latent_dim: int = 0, col_align: int = COL_ALIGN) -> int:
    """Dynamic shared memory of the step's largest block (the decoder pass:
    the product stages, three activation tiles of the widest padded hidden
    layer, which also holds [dmu | dlv], strided 8 mod 16 floats, and a
    dmean tile)."""
    widest = max([_round_up(h, col_align) for h in hidden]
                 + [2 * _round_up(latent_dim, col_align)])
    ld = widest + (24 - widest % 16) % 16
    return 4 * (_STAGE_FLOATS + 3 * TM * ld + TM * (BN + 8))


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
    # 0: the kernel picks its route from the shapes; 1: the fused route; a
    # larger value: the wide route aiming at that many blocks a launch
    route: int = 0

    def __init__(self, stacked_model, combine: str,
                 col_align: int = COL_ALIGN):
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
        self.col_align = col_align
        self.Zp, self.Cp, self.Dp = (_round_up(n, col_align)
                                     for n in (self.Z, self.C, self.D))
        self.Hp = [_round_up(h, col_align) for h in self.H]
        self._true_shapes, self._shapes, self._rows = self._param_shapes()
        self._param_names = list(self._shapes)
        self._sizes = {k: _numel(v) for k, v in self._shapes.items()}
        self._workspace: Dict[tuple, torch.Tensor] = {}

    # ---- layout ---------------------------------------------------------------
    def _param_shapes(self):
        """Per-fold shapes of the named layout, true and padded, and for
        each weight matrix the row blocks (true start, padded start,
        length) that its input is made of. alpha comes last (the kernel's
        weight-gradient pass covers every name before it)."""
        M, L = self.M, self.L
        true, padded, rows = {}, {}, {}

        def add(name, blocks, n, n_p):
            """blocks: (true, padded) widths of the input's parts; none
            for a vector."""
            k = sum(b[0] for b in blocks)
            k_p = sum(b[1] for b in blocks)
            true[name] = (M, k, n) if blocks else (M, n)
            padded[name] = (M, k_p, n_p) if blocks else (M, n_p)
            at = at_p = 0
            rows[name] = []
            for width, width_p in blocks:
                rows[name].append((at, at_p, width))
                at, at_p = at + width, at_p + width_p

        blocks = [(self.D, self.Dp), (self.C, self.Cp)]
        for l in range(L):
            add(f"enc_w{l}", blocks, self.H[l], self.Hp[l])
            add(f"enc_b{l}", [], self.H[l], self.Hp[l])
            blocks = [(self.H[l], self.Hp[l])]
        for head in ("mu", "lv"):
            add(f"w{head}", blocks, self.Z, self.Zp)
            add(f"b{head}", [], self.Z, self.Zp)
        blocks = [(self.Z, self.Zp), (self.C, self.Cp)]
        for l in range(L):
            h, h_p = self.Hr[l], self.Hp[L - 1 - l]
            add(f"dec_w{l}", blocks, h, h_p)
            add(f"dec_b{l}", [], h, h_p)
            blocks = [(h, h_p)]
        add("vm", blocks, self.D, self.Dp)
        add("cm", [], self.D, self.Dp)
        add("lvo", [], self.D, self.Dp)
        true["alpha"] = padded["alpha"] = (M,)
        rows["alpha"] = []
        return true, padded, rows

    def widen(self, named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Named tensors at their true widths -> the padded kernel layout
        (contiguous; padded entries zero)."""
        out = {}
        for k in self._param_names:
            t = named[k]
            if self._true_shapes[k] == self._shapes[k]:
                out[k] = t.contiguous()
                continue
            wide = t.new_zeros((t.shape[0],) + self._shapes[k])
            n = self._true_shapes[k][-1]
            if not self._rows[k]:
                wide[..., :n] = t
            for at, at_p, width in self._rows[k]:
                wide[:, :, at_p:at_p + width, :n] = t[:, :, at:at + width]
            out[k] = wide
        return out

    def strip(self, named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The padded kernel layout -> named tensors at their true widths
        (views where nothing was padded)."""
        out = {}
        for k in self._param_names:
            t = named[k]
            if self._true_shapes[k] == self._shapes[k]:
                out[k] = t
                continue
            n = self._true_shapes[k][-1]
            if not self._rows[k]:
                out[k] = t[..., :n]
                continue
            parts = [t[:, :, at_p:at_p + width, :n]
                     for _, at_p, width in self._rows[k]]
            out[k] = parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)
        return out

    def pad_params(self, packed: dict) -> Dict[str, torch.Tensor]:
        """The packed tree -> the named, padded kernel layout."""
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
        return self.widen(out)

    def unpad_named(self, g: Dict[str, torch.Tensor]) -> dict:
        """Named, padded layout (params or gradients) -> the packed tree."""
        L = self.L
        g = self.strip(g)
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
        (x, c, rm, nvalid) with B padded to ``row_align`` and the feature
        and covariate widths to ``col_align``."""
        B = x_packed.shape[2]
        pad = _round_up(B, self.row_align) - B
        x = torch.nn.functional.pad(x_packed.float(),
                                    (0, self.Dp - self.D, 0, pad))
        c = torch.nn.functional.pad(c.float(), (0, self.Cp - self.C, 0, pad))
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
        loss on the true widths cut out of the padded layout (``nvalid`` is
        max(sum(rm), 1), which the loss recomputes). It computes in fp32,
        or in fp64 when x is fp64."""
        work = _work_dtype(x)
        with torch.enable_grad():
            leaves = {k: v.detach().to(work).requires_grad_()
                      for k, v in named.items()}
            packed = self.unpad_named(leaves)
            x = x[..., :self.D].to(work)
            fwd = self.model.forward(packed, x, c[..., :self.C].to(work),
                                     self.combine, eps.to(work))
            losses = self.model.loss(packed, x, fwd, rm.to(work))
            grads = torch.autograd.grad(losses["total"].sum(),
                                        list(leaves.values()),
                                        allow_unused=True)
        out = {k: torch.zeros_like(leaves[k]) if g is None else g
               for k, g in zip(leaves, grads)}
        return {k: v.detach() for k, v in losses.items()}, out

    def _run(self, named, x, c, eps, rm, nvalid):
        """(losses, named gradients, flat gradient buffer): the plain
        version gives the named gradients, the kernel the flat buffer, and
        the other of the two is None."""
        if x.device.type == "cpu":
            return self.reference(named, x, c, eps, rm, nvalid) + (None,)
        if x.device.type != "cuda":
            raise ValueError(f"fused_train_step: no kernel for {x.device}")
        losses, flat = fused_train_step(self, named, x, c, eps, rm, nvalid)
        return losses, None, flat

    def named_views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The flat gradient buffer as named [F, ...] views of it."""
        folds = flat.numel() // sum(self._sizes.values())
        sizes = [folds * self._sizes[k] for k in self._param_names]
        return {k: v.view((folds,) + self._shapes[k])
                for k, v in zip(self._param_names, flat.split(sizes))}

    def loss_and_grads_padded(self, named, x, c, eps, rm, nvalid):
        """(losses {total, kl, ll: [F]}, gradients in the named layout)."""
        losses, grads, flat = self._run(named, x, c, eps, rm, nvalid)
        return losses, self.named_views(flat) if grads is None else grads

    def loss_and_grads_flat(self, named, x, c, eps, rm, nvalid):
        """(losses, every gradient in one flat fp32 tensor, back to back in
        ``_param_names`` order, each [F, ...] fold-major): the buffer the
        kernel wrote, or on the CPU the plain version's gradients laid out
        the same way. The trainer's entry: it builds no per-parameter
        views."""
        losses, grads, flat = self._run(named, x, c, eps, rm, nvalid)
        if flat is None:
            flat = torch.cat([grads[k].reshape(-1).float()
                              for k in self._param_names])
        return losses, flat

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
    if (m, d) != (step.M, step.Dp):
        raise ValueError(f"{name}: x has shape {tuple(x.shape)}, expected "
                         f"[F, {step.M}, B, {step.Dp}] (d_max {step.D} "
                         f"padded to {step.col_align}: see pack_batch)")
    for t, what, want in ((c, "c", (folds, rows, step.Cp)),
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
    smem = smem_bytes(step.H, step.Z, step.col_align)
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


def _ints(step: FusedTrainStep, folds: int, rows: int, tile_rows: int):
    """csrc/train_step.cuh's int table for these shapes."""
    return ([folds, step.M, rows, step.L, step.Z, step.Zp, step.Cp, step.Dp,
             COMBINES.index(step.combine), tile_rows, step.route]
            + list(step.model.input_dim_list) + step.Hp)


def plan(step: FusedTrainStep, folds: int, rows: int, tile_rows: int = None):
    """The route the kernel takes for these shapes: {wide, enc0_splits,
    col_groups, launches}. Loads the kernel library."""
    ints = _ints(step, folds, rows, tile_rows or rows)
    out = (ctypes.c_int * 4)()
    lib = _build.load_library()
    if lib.mmnm_train_step_plan((ctypes.c_int * len(ints))(*ints), out) != 0:
        raise ValueError(f"fused_train_step: shapes {ints} refused by the "
                         "kernel")
    return dict(zip(("wide", "enc0_splits", "col_groups", "launches"), out))


def launch(step: FusedTrainStep, named, x, c, eps, rm, nvalid,
           tile_rows: int, dtype) -> Tuple[dict, torch.Tensor]:
    """One step on the card: every launch of csrc/train_step.cuh. Weight
    gradients sum their rows in groups of ``tile_rows`` (partials summed in
    group order when there is more than one group). Returns (losses, the
    flat gradient buffer)."""
    folds, rows = _check(step, named, x, c, eps, rm, nvalid, dtype)
    ints = _ints(step, folds, rows, tile_rows)
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
    # the gradients back to back in one buffer, then the losses [F, 3]
    sizes = [folds * step._sizes[k] for k in step._param_names]
    count = sum(sizes)
    flat = torch.empty(count + 3 * folds, device=x.device)
    losses = flat[count:].view(folds, 3)
    base = flat.data_ptr()
    starts = [0]
    for size in sizes:
        starts.append(starts[-1] + size)
    ptrs = ([t.data_ptr() for t in (x, c, eps, rm, nvalid)]
            + [named[k].data_ptr() for k in step._param_names]
            + [base + 4 * at for at in starts])   # ends on the losses
    ptrs_c = (ctypes.c_void_p * (len(ptrs) + 1))(*ptrs, work.data_ptr())
    with torch.cuda.device(x.device):
        rc = lib.mmnm_train_step(ptrs_c, ints_c, bf16,
                                 _build.stream_of(x.device))
    _build.check_launch(lib, rc, "fused_train_step")
    return ({"total": losses[:, 0], "kl": losses[:, 1], "ll": losses[:, 2]},
            flat[:count])


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
