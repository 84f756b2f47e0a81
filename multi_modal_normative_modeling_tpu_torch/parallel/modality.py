"""Expert parallelism: the packed modality axis split over ranks
(counterpart of parallel/modality.py).

The fusions reduce over the modality axis with sums: PoE's total precision
is a sum of the experts' precisions, MoE's mixture mean a sum over M, gPoE
only reweights the summands. Split over a 'modality' mesh axis, each rank
holds its modalities' encoders and decoders and only [B, latent]-sized
statistics cross ranks. The JAX package writes this with ``shard_map`` (the
``M,D`` form) or lets GSPMD place it (the ``F,M,D`` form); the port runs
one process per mesh slot (parallel/mesh.py) and writes the collectives out:

  M,D     ``EPFoldTrainer``: the cvae loss of ``ep_loss``, each fusion
          (``fused_stats_collective``) a sum over the rank's modalities
          followed by one all_reduce over the 'modality' ranks;
  F,M,D   the packed trainers with ``mesh=`` and a plan of this module
          (``packed_fold_shardings``, ``grouped_fold_shardings``,
          ``grouped_e2e_fold_shardings``): each product of the layout runs
          on the rank's part of its leaves' modality axis, the statistics
          are gathered whole (ops/shard.py) and every variant's loss runs
          on them unchanged.

A leaf's modality axis is split when the axis's rank count divides it
(``ep_divisible_spec``), else every rank holds it whole: the ragged width
groups of a mixed-width cohort replicate, as in JAX.

Gradients through the collectives, JAX's rule under ``shard_map``: a value
is either alike on every rank of the 'modality' axis (invariant: the loss,
the fused statistics, z, a gathered activation) or the rank's own
(varying: its modalities' activations). Every rank computes the whole loss
and differentiates it. A sum over the axis into an invariant value
(``Mesh.psum``) hands its alike cotangent to each rank's summand unchanged;
an all_gather into an invariant value (``Mesh.all_gather_cat``) keeps the
rank's part of its alike cotangent; an invariant value entering a rank's
own products (``Mesh.vary``: z into the decoders, an activation sliced for
split leaves) sums the ranks' cotangents, each rank's share of the whole.
So every gradient comes out whole on the rank that holds the leaf, and a
leaf every rank holds whole gets the same gradient on each. On a
one-modality-a-rank split the sums are the unmeshed run's own additions.
Over 'data' each rank's loss is its rows' share of the batch mean (global
row counts, ops/losses.global_row_counts), and every gradient is summed
over 'data', as on the fold-parallel trainer's data axis.

Draws. In the ``F,M,D`` form a rank draws the whole batch's noise and keeps
its rows (GSPMD's semantics: the unmeshed run's draws). In the ``M,D`` form
JAX folds the data index into each step's key, so the data shards draw
apart and the modality shards share one draw; the port's ``FoldNoise``
gives data shard d its own generator per fold, seeded from (seed, d), and
the tests replay JAX's threefry draws (ReplayNoise). Philox and threefry
differ, as everywhere in the port.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.stacked import decoder_input
from ..ops.linear import add_rows, fold_expand, leaky_relu
from ..ops.losses import (
    HALF_LOG_2PI,
    global_row_counts,
    kl_standard_normal,
    row_count,
)
from ..ops.shard import modality_shard, part, whole
from ..train.packed import PackedMultiFoldTrainer, _leaves, _rebuild
from .folds import MeshRun
from .mesh import Mesh, axis_range, build_mesh, fold_range, row_range
from . import distributed


def make_ep_mesh(n_modality: int, n_data: Optional[int] = None,
                 device="cpu") -> Mesh:
    """A ('modality', 'data') mesh over the run's ranks
    (parallel/modality.py:57-71)."""
    world = distributed.world_size()
    if n_data is None:
        if world % n_modality:
            raise ValueError(f"{world} devices not divisible into "
                             f"{n_modality} modality groups")
        n_data = world // n_modality
    if n_modality * n_data != world:
        raise ValueError(f"mesh {n_modality}x{n_data} != {world} devices")
    return build_mesh({"modality": n_modality, "data": n_data}, device)


def make_ep_mesh3(n_fold: int, n_modality: int,
                  n_data: Optional[int] = None, device="cpu") -> Mesh:
    """A ('fold', 'modality', 'data') mesh (parallel/modality.py:74-90)."""
    world = distributed.world_size()
    if n_data is None:
        if world % (n_fold * n_modality):
            raise ValueError(
                f"{world} devices not divisible into "
                f"{n_fold}x{n_modality} fold x modality groups")
        n_data = world // (n_fold * n_modality)
    if n_fold * n_modality * n_data != world:
        raise ValueError(f"mesh {n_fold}x{n_modality}x{n_data} != "
                         f"{world} devices")
    return build_mesh({"fold": n_fold, "modality": n_modality,
                       "data": n_data}, device)


def ep_divisible_spec(nm: int, shape, maxis: int = 1,
                      lead=("fold",)) -> tuple:
    """The one divisible-or-replicate rule (parallel/modality.py:143-162):
    dim ``maxis`` of a leaf of ``shape`` is split over 'modality' when
    ``nm`` (the axis's rank count) divides its length, else replicated.
    Returns the leaf's spec, one name or None per leading dim, as JAX's
    PartitionSpec: ('fold', 'modality') or ('fold',)."""
    nd = len(shape)
    names = list(lead[:nd])
    if nd > maxis and shape[maxis] % nm == 0:
        return tuple(names + [None] * (maxis - len(names)) + ["modality"]
                     + [None] * (nd - maxis - 1))
    return tuple(names)


class ModalityShard:
    """The 'modality' axis of ``mesh`` as ops/shard.py uses it."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.size = mesh.axis("modality")
        self.index = mesh.index("modality")

    def splits(self, n: int) -> bool:
        return self.size > 1 and n % self.size == 0

    def span(self, n: int) -> Tuple[int, int]:
        return axis_range(n, self.size, self.index, "modalities")

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return self.mesh.all_gather_cat(t, "modality", dim)

    def vary(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.vary(t, "modality")


class EPPlan(NamedTuple):
    """What a rank holds of packed training on an expert-parallel mesh:
    folds [f0, f1), rows [r0, r1) of each batch's ``batch_rows``, and the
    split of every leaf's modality axis (``ep_divisible_spec``);
    ``shard_x`` says whether the batches' features split with it (the
    dual-bank end-to-end layout splits its [2M] decoder axis, so every
    rank keeps its groups' features whole)."""
    folds: Tuple[int, int]
    rows: Tuple[int, int]
    batch_rows: int
    tensor: bool = False
    shard_x: bool = True


def _plan(mesh: Mesh, n_folds: int, batch_rows: int,
          shard_x: bool) -> EPPlan:
    return EPPlan(fold_range(mesh, n_folds), row_range(mesh, batch_rows),
                  batch_rows, shard_x=shard_x)


def packed_fold_shardings(mesh: Mesh, n_folds: int, batch_rows: int
                          ) -> EPPlan:
    """The padded packed trainer's plan (parallel/modality.py:93-124):
    every [F, M, ...] leaf over ('fold', 'modality'), the features
    [F, NB, M, B, d] over (fold, modality, data rows), the covariates and
    masks over (fold, data rows)."""
    return _plan(mesh, n_folds, batch_rows, True)


def grouped_fold_shardings(mesh: Mesh, n_folds: int, batch_rows: int
                           ) -> EPPlan:
    """The width-grouped trainer's plan (parallel/modality.py:165-203): the
    [M] leaves and each width group's [G] leaves and features split where
    the modality axis divides them, the ragged groups replicate."""
    return _plan(mesh, n_folds, batch_rows, True)


def grouped_e2e_fold_shardings(mesh: Mesh, n_folds: int, batch_rows: int
                               ) -> EPPlan:
    """The dual-bank end-to-end trainer's plan (parallel/modality.py:
    219-261): the encoder as the grouped plan, the decoders' [2M] and
    [2G] axes where they divide, both banks of a rank's experts local; the
    classifier and its BatchNorm state (the model's own module, not in the
    packed tree) over 'fold' only."""
    return _plan(mesh, n_folds, batch_rows, False)


def leaf_specs(mesh: Mesh, tree):
    """``ep_divisible_spec`` of every leaf of a packed tree ([F, X, ...]
    leaves), in the tree's structure."""
    nm = mesh.axis("modality")
    if isinstance(tree, dict):
        return {k: leaf_specs(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [leaf_specs(mesh, v) for v in tree]
    return ep_divisible_spec(nm, tuple(tree.shape))


def fused_stats_collective(mus: torch.Tensor, variances: torch.Tensor,
                           combine: str, alpha_full: torch.Tensor,
                           m_total: int, mesh: Mesh,
                           axis: str = "modality",
                           owned: Optional[Sequence[int]] = None):
    """ops/fusion.combine_latent over a rank-split modality axis
    (parallel/modality.py:306-350). ``mus``/``variances`` are this rank's
    [F, M_local, B, Z] experts (the port's fold axis in front);
    ``alpha_full`` the whole [F, M] gPoE weights (the softmax couples every
    entry), whose entries ``owned`` (the rank's modalities; by default its
    contiguous block, as in JAX) weigh the rank's experts. Each sum over the
    modalities is the rank's sum followed by one all_reduce over ``axis``;
    returns the fused ([F, B, Z], [F, B, Z]), equal on every rank of the
    axis."""
    combine = combine.lower()

    def total(t):
        return mesh.psum(torch.sum(t, dim=1), axis)

    if combine == "poe":
        precision = 1.0 / variances
        tot = total(precision)
        return total(mus * precision) / tot, 1.0 / tot
    if combine == "gpoe":
        weights = mesh.vary(torch.softmax(alpha_full, dim=-1), axis)
        if owned is None:
            lo = mesh.index(axis) * mus.shape[1]
            owned = range(lo, lo + mus.shape[1])
        w_local = weights[:, list(owned)]
        weighted = fold_expand(w_local[:, :, None, None],
                               variances.shape) / variances
        tot = total(weighted)
        return total(mus * weighted) / tot, 1.0 / tot
    if combine == "moe":
        return total(mus) / m_total, total(variances) / m_total
    if combine == "mopoe":
        poe_mu, poe_var = fused_stats_collective(
            mus, variances, "poe", alpha_full, m_total, mesh, axis, owned)
        # the PoE expert is the same on every rank after its sums: once
        return ((total(mus) + poe_mu) / (m_total + 1),
                (total(variances) + poe_var) / (m_total + 1))
    raise ValueError("No such combination method")


def ep_fuse(variant: str, mus: torch.Tensor, logvars: torch.Tensor,
            combine: str, alpha_full: torch.Tensor, m_total: int,
            mesh: Mesh, owned: Optional[Sequence[int]] = None):
    """MultimodalCVAE.fuse (the variant's fusion) over a rank-split
    modality axis: ``mus``/``logvars`` [F, M_local, B, Z] of the rank's
    modalities ``owned``. Returns (fused_mu, fused_logvar) [F, B, Z]."""
    variances = torch.exp(logvars)
    if variant == "mmjsd":
        fused_mu, fused_var = fused_stats_collective(
            mus, variances, "poe", alpha_full, m_total, mesh, owned=owned)
    elif variant == "mvtcae":
        if combine.lower() == "poe":
            # ProductOfExperts2 fed variances as logvars (models/multimodal)
            precision = torch.exp(-variances)
            tot = mesh.psum(torch.sum(precision, dim=1), "modality")
            fused_mu = mesh.psum(torch.sum(mus * precision, dim=1),
                                 "modality") / tot
            fused_var = -torch.log(tot)
        else:
            fused_mu, fused_var = fused_stats_collective(
                mus, variances, combine, alpha_full, m_total, mesh,
                owned=owned)
        fused_var = torch.clamp(fused_var, min=1e-6)
    elif m_total == 1 and variant != "nmmlp":
        return mus[:, 0], logvars[:, 0]
    else:
        fused_mu, fused_var = fused_stats_collective(
            mus, variances, combine, alpha_full, m_total, mesh, owned=owned)
    return fused_mu, torch.log(fused_var)


def owned_modalities(mesh: Mesh, input_dim_list: Sequence[int]
                     ) -> List[int]:
    """The modalities this rank scores: its block of the width-grouped
    order (models/grouped.py), the split of the layouts' [M] leaves. On a
    uniform cohort that is its block of the cohort's order."""
    from ..models.grouped import width_groups

    perm = [m for _, idx in width_groups(input_dim_list) for m in idx]
    lo, hi = axis_range(len(perm), mesh.axis("modality"),
                        mesh.index("modality"), "modalities")
    return sorted(perm[lo:hi])


@torch.no_grad()
def ep_pred_recon_fused(model, owned: Sequence[int], xes: dict, cs: dict,
                        combine: str, eps: torch.Tensor, mesh: Mesh) -> dict:
    """Expert-parallel scoring of a fold-stacked MultimodalCVAE skeleton
    model: the encoder kernel (K1) on each of the rank's modalities
    ``owned`` ({m: [F, B, D_m]} features ``xes``, covariates ``cs``), the
    fusion as collectives over 'modality' (``ep_fuse``), z from ``eps``
    [F, B, Z], then the decode+deviation kernel (K2) on each owned
    modality. Returns {m: (recon [F, B, D_m], dev [F, B])}."""
    from ..models.cvae import reparameterize

    stats = [model.enc[m].fused(xes[m], cs[m]) for m in owned]
    fused_mu, fused_logvar = ep_fuse(
        model.variant, torch.stack([mu for mu, _ in stats], dim=1),
        torch.stack([lv for _, lv in stats], dim=1), combine, model.alpha,
        model.modalities, mesh, owned)
    z = reparameterize(fused_mu, fused_logvar, eps)
    return {m: model.dec[m].fused_pred_deviation(z, cs[m], xes[m])
            for m in owned}


def gather_owned(mesh: Mesh, local: dict, n_folds: int,
                 n_modalities: int) -> List[np.ndarray]:
    """Every modality's whole [F, rows, ...] array from the ranks' parts
    ({m: [F/nf, rows/nd, ...]} of the modalities each scored), on every
    rank."""
    pieces = mesh.all_gather_object((mesh.index("fold"), mesh.index("data"),
                                     {m: np.asarray(a)
                                      for m, a in local.items()}))
    nf, nd = mesh.axis("fold"), mesh.axis("data")
    grid = {}
    for fi, di, arrays in pieces:
        for m, a in arrays.items():
            grid[(m, fi, di)] = a
    return [np.concatenate([
        np.concatenate([grid[(m, fi, di)] for di in range(nd)], axis=1)
        for fi in range(nf)], axis=0) for m in range(n_modalities)]


def ep_loss(stacked, params, x_local: torch.Tensor, c: torch.Tensor,
            eps: torch.Tensor, mask: Optional[torch.Tensor], combine: str,
            mesh: Mesh):
    """The cvae loss of the padded layout (StackedMultimodalCVAE.forward and
    .loss) on this rank's modalities, each modality reduction a collective
    (parallel/modality.py:372-424): ``params`` the rank's packed tree
    ([F, M_local, ...] leaves, alpha whole or split), ``x_local``
    [F, M_local, B, d_max], ``c`` [F, B, C], ``eps`` [F, B, Z], ``mask``
    [F, B]. Returns (total [F], {"total", "kl", "ll"}), the whole loss on
    every rank."""
    m_total = stacked.modalities
    act = leaky_relu if stacked.non_linear else (lambda a: a)
    e = params["enc"]
    m_loc = x_local.shape[1]
    h = torch.cat([x_local, c[:, None].expand(-1, m_loc, -1, -1)], dim=3)
    for lay in e["layers"]:
        h = act(add_rows(h @ lay["w"], lay["b"]))
    mus = add_rows(h @ e["wmu"], e["bmu"])
    logvars = add_rows(h @ e["wlv"], e["blv"])
    alpha_full = mesh.all_gather_cat(params["alpha"], "modality", 1) \
        if params["alpha"].shape[1] != m_total else params["alpha"]
    fused_mu, fused_var = fused_stats_collective(
        mus, torch.exp(logvars), combine, alpha_full, m_total, mesh)
    fused_logvar = torch.log(fused_var)
    z = fused_mu + eps.to(fused_mu.dtype) * torch.exp(0.5 * fused_logvar)
    d = params["dec"]
    g = decoder_input(mesh.vary(torch.cat([z, c], dim=2), "modality"),
                      d["layers"][0]["w"].shape[1])
    for lay in d["layers"]:
        g = act(add_rows(g @ lay["w"], lay["b"]))
    means = add_rows(g @ d["wm"], d["bm"])
    lo = mesh.index("modality") * m_loc
    col = stacked.col_mask(x_local.device)[lo:lo + m_loc][None, :, None, :]
    lvo = fold_expand(d["lvo"][:, :, None, :], means.shape)
    ll_rows = torch.sum((-0.5 * (x_local - means) ** 2 * torch.exp(-lvo)
                         - 0.5 * lvo - HALF_LOG_2PI) * col, dim=3)
    if mask is None:
        ll = torch.mean(ll_rows, dim=2)
    else:
        w = mask.to(ll_rows.dtype)
        ll = (torch.sum(ll_rows * w[:, None, :], dim=2)
              / torch.clamp(row_count(w), min=1.0)[:, None])
    ll_sum = mesh.psum(torch.sum(ll, dim=1), "modality")
    kl = kl_standard_normal(fused_mu, fused_logvar, mask)
    total = m_total * kl - ll_sum
    return total, {"total": total, "kl": m_total * kl, "ll": ll_sum}


def build_ep_step(stacked, combine: str, mesh: Mesh):
    """step(params, x_local, c, eps, mask) -> (loss [F], grads): one
    expert-parallel step's loss and the whole gradient of every leaf of the
    rank's packed tree (parallel/modality.py:427-491 without the optimizer,
    which the trainers apply: ``MaskedAdam``). ``params`` holds leaves
    that require grad; alpha [F, M] is split over the ranks with the rest.
    The gradients are summed over 'data'."""
    _check_ep_geometry(stacked, mesh)

    def step(params, x_local, c, eps, mask=None):
        leaves = _leaves(params)
        counts = None
        if mesh.axis("data") > 1 and mask is not None:
            counts = mesh.all_reduce_(torch.sum(mask, dim=-1), "data")
        with torch.enable_grad(), global_row_counts(counts):
            total, _ = ep_loss(stacked, params, x_local, c, eps, mask,
                               combine, mesh)
            grads = torch.autograd.grad(total.sum(), leaves,
                                        allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        if mesh.axis("data") > 1:
            grads = [mesh.all_reduce_(g.clone(), "data") for g in grads]
            total = mesh.all_reduce_(total.detach().clone(), "data")
        return total.detach(), _rebuild(params, grads)

    return step


def _check_ep_geometry(stacked, mesh: Mesh) -> None:
    if stacked.modalities % mesh.axis("modality"):
        raise ValueError(
            f"{stacked.modalities} modalities not divisible over the "
            f"{mesh.axis('modality')}-way 'modality' mesh axis")


def data_seed(seed: int, index: int) -> int:
    """The seed of data shard ``index``'s generators in the ``M,D`` form:
    (seed, index) through numpy's SeedSequence, the role of JAX's
    fold_in(key, index)."""
    return int(np.random.SeedSequence([int(seed), int(index)])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


class PackedMeshRun(MeshRun):
    """One rank's part of a packed run on an expert-parallel mesh by an
    ``EPPlan``: the model's folds as ``MeshRun`` holds them, the packed
    tree's modality axes as ``leaf_specs`` splits them. The logs, the model
    and the train state are gathered into the unmeshed layout, as
    ``MeshRun`` does. ``noise_per_data``: the ranks along 'data' hold
    generators of their own (the ``M,D`` form), which the train state
    keeps one per (fold, data index)."""

    def __init__(self, model, mesh: Mesh, plan: EPPlan,
                 noise_per_data: bool = False):
        super().__init__(model, mesh, plan)
        self.shard = ModalityShard(mesh)
        self.noise_per_data = noise_per_data
        self.leaves: List[Tuple[tuple, bool]] = []   # (whole shape, split)

    # -- the packed tree ------------------------------------------------------
    def local_tree(self, tree):
        """This rank's part of a packed tree of the rank's folds."""
        return _rebuild(tree, [part(t, t.shape[1]) if t.dim() > 1 else t
                               for t in _leaves(tree)])

    @torch.no_grad()
    def whole_tree(self, tree, whole_tree):
        """The rank's folds of ``tree`` with every split leaf gathered
        whole (``whole_tree``: the tree it was cut from, for the
        lengths)."""
        with modality_shard(self.shard):
            return _rebuild(tree, [
                whole(t.detach(), w.shape[1]) if t.dim() > 1 else t.detach()
                for t, w in zip(_leaves(tree), _leaves(whole_tree))])

    def set_leaves(self, local: Sequence[torch.Tensor],
                   whole_shapes: Sequence[tuple]) -> None:
        """The trained leaves in the optimizer's order: each one's whole
        shape ([F of the run, ...]), whether it is split over 'modality',
        and its shape on this rank."""
        self.leaves = [((self.folds,) + tuple(shape[1:]),
                        tuple(t.shape[1:2]) != tuple(shape[1:2]),
                        tuple(t.shape))
                       for t, shape in zip(local, whole_shapes)]

    # -- gathers --------------------------------------------------------------
    def _grid(self, obj):
        """{(fold index, modality index): obj} of the ranks of data index
        0 (with ``noise_per_data`` each carries its data peers' noise)."""
        out = {}
        for f, d, m, o in self.mesh.all_gather_object(
                (self.mesh.index("fold"), self.mesh.index("data"),
                 self.mesh.index("modality"), obj)):
            if d == 0:
                out.setdefault((f, m), o)
            if isinstance(o, dict) and "noise" in o and self.noise_per_data:
                out.setdefault(("noise", f, d), o["noise"])
        return out

    def gather_state(self, state: dict) -> Optional[dict]:
        sizes = [int(np.prod(local)) for _, _, local in self.leaves]
        adam = state["adam"]

        def leaves(flat):
            return [a.reshape(local) for a, (_, _, local) in zip(
                np.split(flat, np.cumsum(sizes)[:-1]), self.leaves)]

        mine = {"adam": {k: leaves(adam[k]) for k in ("flat", "m", "v")},
                "count": adam["count"], "noise": list(state["noise"]),
                "buffers": state["buffers"]}
        grid = self._grid(mine)
        if not self.mesh.primary:
            return None
        nf, nm = self.mesh.axis("fold"), self.mesh.axis("modality")

        def whole_leaf(key, i, split):
            return np.concatenate([
                np.concatenate([grid[(f, m)]["adam"][key][i]
                                for m in range(nm)], axis=1)
                if split else grid[(f, 0)]["adam"][key][i]
                for f in range(nf)], axis=0)

        def flat(key):
            return np.concatenate([whole_leaf(key, i, split).reshape(-1)
                                   for i, (_, split, _) in
                                   enumerate(self.leaves)])

        if self.noise_per_data:
            nd = self.mesh.axis("data")
            noise = [grid[("noise", f, d)][k] for f in range(nf)
                     for k in range(len(grid[("noise", f, 0)]))
                     for d in range(nd)]
        else:
            noise = [s for f in range(nf) for s in grid[(f, 0)]["noise"]]
        return {"adam": {"flat": flat("flat"), "m": flat("m"),
                         "v": flat("v"),
                         "count": np.concatenate(
                             [grid[(f, 0)]["count"] for f in range(nf)])},
                "noise": noise,
                "buffers": {k: np.concatenate([grid[(f, 0)]["buffers"][k]
                                               for f in range(nf)])
                            for k in state["buffers"]}}

    def local_state(self, tensors: dict) -> dict:
        f0, f1 = self.plan.folds
        sizes = [int(np.prod(shape)) for shape, _, _ in self.leaves]
        adam = tensors["adam"]

        def flat(key):
            parts = np.split(np.asarray(adam[key]), np.cumsum(sizes)[:-1])
            out = []
            for a, (shape, split, _) in zip(parts, self.leaves):
                a = a.reshape(shape)[f0:f1]
                if split:
                    lo, hi = self.shard.span(shape[1])
                    a = a[:, lo:hi]
                out.append(a.reshape(-1))
            return np.concatenate(out)

        noise = list(tensors.get("noise") or [])
        if self.noise_per_data and noise:
            nd, d = self.mesh.axis("data"), self.mesh.index("data")
            noise = noise[f0 * nd:f1 * nd][d::nd]
        else:
            noise = noise[f0:f1]
        return {"adam": {"flat": flat("flat"), "m": flat("m"),
                         "v": flat("v"),
                         "count": np.asarray(adam["count"])[f0:f1]},
                "noise": noise,
                "buffers": {k: np.asarray(v)[f0:f1] for k, v in
                            (tensors.get("buffers") or {}).items()}}


def packed_fingerprint(mesh: Mesh) -> str:
    """The mesh in a train state's fingerprint: a meshed run's partial sums
    come in another order, so it resumes only under the same geometry."""
    return ",".join(f"{k}={v}" for k, v in mesh.shape.items())


class EPFoldTrainer(PackedMultiFoldTrainer):
    """The ``M,D`` expert-parallel trainer (parallel/modality.py:494-653):
    every fold at once on the padded packed layout (the port's trainers
    train every fold together), the modalities over 'modality', the batch
    rows over 'data', the cvae loss of ``ep_loss``. ``run``,
    ``run_milestones``, ``run_resumable`` and ``session`` are the packed
    trainer's; the resume fingerprint names the mesh."""

    def __init__(self, model, config, n_samples: int, mesh: Mesh):
        if config.shuffle:
            raise ValueError("EP trainer trains in fixed batch order")
        if config.precision != "fp32":
            raise ValueError("EP trainer is fp32 (parity path)")
        if getattr(model, "variant", None) != "cvae":
            raise ValueError(
                f"expert-parallel (M,D) training supports variant 'cvae' "
                f"only (got {getattr(model, 'variant', None)!r}); use "
                "--packed_xla or the 3-axis --ep_mesh F,M,D form for "
                "mmjsd/mvtcae")
        if model.modalities % mesh.axis("modality"):
            raise ValueError(
                f"{model.modalities} modalities not divisible over the "
                f"{mesh.axis('modality')}-way 'modality' mesh axis")
        if config.batch_size % mesh.axis("data"):
            raise ValueError(
                f"batch_size {config.batch_size} not divisible over the "
                f"{mesh.axis('data')}-way 'data' mesh axis")
        # the ranks along 'data' draw noise of their own
        self.noise_per_data = mesh.axis("data") > 1
        super().__init__(model, config, n_samples, mesh=mesh,
                         shardings_fn=packed_fold_shardings)
        self.loss_meta["path"] = "ep:" + packed_fingerprint(mesh)

    def _loss(self, packed, batch, eps):
        return ep_loss(self.layout, packed, batch["x"][0], batch["c"], eps,
                       batch["mask"], self.config.combine, self.mesh)
