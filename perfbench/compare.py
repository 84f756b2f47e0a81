"""The numbers that decide ``correct``, each against its limit
(``limits/<workload>.json``; PERF.md gives the readings each was set
from).

Training, per checked job (the program's trained parameters and logs
against the reference's, from the same initial parameters, rows and
noise; the logs are each epoch's first-batch loss terms, before its
update):
  * ``loss_gap``: the largest relative gap of a loss term (total, kl, ll)
    of any fold at the first logged epoch: the first step's loss.
  * ``ll_gap``: the largest relative gap of the total and of the
    log-likelihood of any fold at the next logged epochs (up to
    ``loss_epochs``), after the first updates. The KL term is left out
    there: a few parts in 1e4 of it, the fused posterior's drift under
    Adam, read on sound runs (PERF.md).
  * ``change_gap``: by the worst leaf (one parameter tensor of one fold),
    the gap between the norms of the program's and the reference's change
    over the job, over the reference's change of that leaf or of the
    median leaf, whichever is larger. Leaves whose first gradient in the
    reference is under a thousandth of the median leaf's are left out:
    they move by round-off alone.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .inputs import tree_leaves

LOG_TERMS = ("total", "kl", "ll")
QUIET_GRAD = 1e-3


def packed_to_tree(packed: dict, cfg: dict) -> dict:
    """The program's packed tree (leaves [F, M, ...]; encoder layer 0's
    rows are [x padded to the widest modality | covariates]; the decoder's
    outputs padded to the widest) as the per-modality tree, on the host."""
    dims, d_max = list(cfg["input_dim_list"]), max(cfg["input_dim_list"])
    e, d = packed["enc"], packed["dec"]

    def host(t):
        return t.detach().float().cpu()

    tree = {"enc": [], "dec": [], "alpha": host(packed["alpha"])}
    for m, dm in enumerate(dims):
        hidden = []
        for l, layer in enumerate(e["layers"]):
            w = layer["w"][:, m]
            if l == 0:
                w = torch.cat([w[:, :dm], w[:, d_max:]], dim=1)
            hidden.append({"w": host(w), "b": host(layer["b"][:, m])})
        tree["enc"].append({
            "hidden": hidden,
            "mu": {"w": host(e["wmu"][:, m]), "b": host(e["bmu"][:, m])},
            "logvar": {"w": host(e["wlv"][:, m]), "b": host(e["blv"][:, m])}})
        tree["dec"].append({
            "hidden": [{"w": host(layer["w"][:, m]),
                        "b": host(layer["b"][:, m])}
                       for layer in d["layers"]],
            "mean": {"w": host(d["wm"][:, m, :, :dm]),
                     "b": host(d["bm"][:, m, :dm])},
            "logvar_out": host(d["lvo"][:, m, None, :dm])})
    return tree


def _fold_leaves(tree) -> Dict[tuple, torch.Tensor]:
    """{(path, fold): tensor} of a fold-stacked tree, on the host, fp64."""
    out = {}
    for path, t in tree_leaves(tree):
        t = t.detach().double().cpu()
        for f in range(t.shape[0]):
            out[(path, f)] = t[f]
    return out


def train_loss_numbers(prog_logs: dict, ref_logs: dict, epochs: int
                       ) -> Dict[str, float]:
    """``loss_gap`` and ``ll_gap`` over the first ``epochs`` logged
    epochs."""
    gaps = loss_gaps(prog_logs, ref_logs, epochs)
    if "shape" in gaps:
        return {"loss_gap": float("inf"), "ll_gap": float("inf")}
    later = [gaps[f"{k}.{e}"] for k in ("total", "ll")
             for e in range(1, epochs)]
    return {"loss_gap": max(gaps[f"{k}.0"] for k in LOG_TERMS),
            "ll_gap": max(later, default=0.0)}


def loss_gaps(prog_logs: dict, ref_logs: dict, epochs: int
              ) -> Dict[str, float]:
    """{"<term>.<epoch>": the largest relative gap over the folds} of the
    first ``epochs`` logged epochs."""
    out = {}
    for k in LOG_TERMS:
        p = np.asarray(prog_logs[k], np.float64)[:, :epochs]
        r = np.asarray(ref_logs[k], np.float64)[:, :epochs]
        if p.shape != r.shape:
            return {"shape": float("inf")}
        gap = np.abs(p - r) / np.abs(r)
        gap[~np.isfinite(gap)] = np.inf
        for e in range(epochs):
            out[f"{k}.{e}"] = float(gap[:, e].max())
    return out


def change_gap(init: dict, prog_tree: dict, ref_tree: dict,
               first_grad: dict) -> float:
    """By the worst leaf, the gap between the norms of the program's and
    the reference's change from ``init``; ``first_grad`` is the
    reference's first gradient {leaf path: [F, ...]}."""
    start = _fold_leaves(init)
    prog, ref = _fold_leaves(prog_tree), _fold_leaves(ref_tree)
    if set(prog) != set(ref) or any(prog[k].shape != ref[k].shape
                                    for k in ref):
        return float("inf")
    quiet = quiet_leaves(first_grad)
    moved = [k for k in start if k not in quiet]
    p_norm = {k: float(torch.linalg.vector_norm(prog[k] - start[k]))
              for k in moved}
    r_norm = {k: float(torch.linalg.vector_norm(ref[k] - start[k]))
              for k in moved}
    r_median = float(np.median(list(r_norm.values())))
    gaps = np.array([abs(p_norm[k] - r_norm[k]) / max(r_norm[k], r_median)
                     for k in moved])
    return float(gaps.max()) if np.isfinite(gaps).all() else float("inf")


def quiet_leaves(first_grad: dict) -> set:
    """(leaf path, fold) of the leaves whose first gradient in the
    reference is under QUIET_GRAD of the median leaf's."""
    grads = {}
    for path, g in first_grad.items():
        g = g.detach().double().cpu()
        for f in range(g.shape[0]):
            grads[(path, f)] = float(torch.linalg.vector_norm(g[f]))
    g_median = float(np.median(list(grads.values())))
    return {k for k, v in grads.items() if v < QUIET_GRAD * g_median}


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's largest reading over the checked units."""
    out: Dict[str, float] = {}
    for numbers in readings:
        for k, v in numbers.items():
            out[k] = max(out.get(k, 0.0), v)
    return out
