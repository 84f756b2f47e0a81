"""Everything a run feeds the program, made from ``--seed`` on the device.

Each input draws from its own ``torch.Generator`` on the card, seeded from
(seed, what, index), in a few large calls: the same seed gives the same
inputs, and inputs of another role or index do not shift when one more is
drawn. Parameters come as the fold-stacked per-modality tree in the JAX
package's layout (the checkpoint layout both packages read; weights
[F, fan_in, fan_out]):

    {"enc": [{"hidden": [{"w", "b"}, ...], "mu": {"w", "b"},
              "logvar": {"w", "b"}}, ...],
     "dec": [{"hidden": [...], "mean": {"w", "b"}, "logvar_out" [F, 1, D]},
             ...],
     "alpha" [F, M]}
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch


def generator(seed: int, what: str, index: int, device) -> torch.Generator:
    """A generator on ``device`` for input ``what`` number ``index``."""
    words = [seed % 2**32, seed // 2**32 % 2**32, index]
    words += [ord(ch) for ch in what]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) % 2**63)


def _linear_shapes(cfg: dict) -> List[Tuple[tuple, Tuple[int, int]]]:
    """(tree path, (fan_in, fan_out)) of every linear layer, in tree
    order."""
    hidden, z, c = list(cfg["hidden_dim"]), cfg["latent_dim"], cfg["c_dim"]
    out = []
    for m, d in enumerate(cfg["input_dim_list"]):
        k = d + c
        for l, h in enumerate(hidden):
            out.append((("enc", m, "hidden", l), (k, h)))
            k = h
        out.append((("enc", m, "mu"), (k, z)))
        out.append((("enc", m, "logvar"), (k, z)))
    for m, d in enumerate(cfg["input_dim_list"]):
        k = z + c
        for l, h in enumerate(hidden[::-1]):
            out.append((("dec", m, "hidden", l), (k, h)))
            k = h
        out.append((("dec", m, "mean"), (k, d)))
    return out


def init_tree(cfg: dict, folds: int, gen: torch.Generator) -> dict:
    """Parameters of ``folds`` folds as nn.Linear draws them (weight and
    bias uniform in +-1/sqrt(fan_in)), each decoder's output log-variance
    at -3 as the model starts it, the gPoE weights uniform in [-1, 1]: one
    draw for all."""
    device = gen.device
    shapes = _linear_shapes(cfg)
    m_count = len(cfg["input_dim_list"])
    total = sum(k * n + n for _, (k, n) in shapes) + m_count
    u = torch.rand((folds, total), generator=gen, device=device) * 2.0 - 1.0
    tree = {"enc": [{"hidden": []} for _ in range(m_count)],
            "dec": [{"hidden": []} for _ in range(m_count)]}
    at = 0
    for path, (k, n) in shapes:
        bound = 1.0 / math.sqrt(k)
        w = u[:, at:at + k * n].reshape(folds, k, n) * bound
        b = u[:, at + k * n:at + k * n + n] * bound
        at += k * n + n
        node = tree[path[0]][path[1]]
        layer = {"w": w.contiguous(), "b": b.contiguous()}
        if path[2] == "hidden":
            node["hidden"].append(layer)
        else:
            node[path[2]] = layer
    for m, d in enumerate(cfg["input_dim_list"]):
        tree["dec"][m]["logvar_out"] = torch.full((folds, 1, d), -3.0,
                                                  device=device)
    tree["alpha"] = u[:, at:at + m_count].contiguous()
    return tree


def tree_leaves(tree, path=()):
    """(path, tensor) of every leaf, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, path + (i,))
    else:
        yield path, tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def one_hot_covariates(gen: torch.Generator, shape: tuple,
                       c_dim: int) -> torch.Tensor:
    """[..., c_dim]: one-hot age in c_dim - 2 bins and one-hot sex in 2, as
    the CLIs condition."""
    device = gen.device
    age = torch.randint(0, c_dim - 2, shape, generator=gen, device=device)
    sex = torch.randint(0, 2, shape, generator=gen, device=device)
    c = torch.zeros(shape + (c_dim,), device=device)
    c.scatter_(-1, age[..., None], 1.0)
    c.scatter_(-1, (c_dim - 2 + sex)[..., None], 1.0)
    return c


def normal(gen: torch.Generator, shape: tuple) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device)
