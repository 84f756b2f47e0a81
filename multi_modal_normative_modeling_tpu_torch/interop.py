"""The boundary between the JAX package's parameter trees and the port.

The JAX package keeps a multimodal cVAE's parameters as the pytree
(models/multimodal.py:83-97, models/cvae.py:26-57)

    {"enc": [{"hidden": [{"w", "b"}, ...], "mu": {"w", "b"},
              "logvar": {"w", "b"}}, ...],
     "dec": [{"hidden": [...], "mean": {"w", "b"}, "logvar_out" [1, D]}, ...],
     "alpha" [M]}

with weights ``[fan_in, fan_out]``. The port's modules store weights
``[F, fan_out, fan_in]`` with a fold axis in front; this module is the only
place that transposes. A module's state-dict key names its tree path:
``enc.0.hidden.1.weight`` is ``tree["enc"][0]["hidden"][1]["w"]``. The
end-to-end model's tree (models/endtoend.py:62-79) adds ``dec_health``,
``dec_disease``, ``classifier`` (``{"blocks": [{"linear", "bn_scale",
"bn_bias"}, ...], "out"}``) and, at the top level, ``bn_state`` (``[{"mean",
"var"}, ...]``), which the port keeps as the classifier's buffers
``classifier.state.*``; the regression's (models/regression.py:33-39) adds
``regressor``, a list of ``{"w", "b"}``. The classifier baseline's
parameters (models/classifier.py:33-34) are the bare ``init_mlp`` list of
``{"w", "b"}``; ``classifier_from_jax`` and ``classifier_to_jax`` carry it
into the port's stacked ``MLPClassifier`` (S configurations) and back.

The packed layout of ``models.stacked`` (all modalities on one axis, the
layout of the fused train step) keeps the JAX orientation; ``packed_*``
convert between it, the fold-stacked module and JAX per-modality trees.
Checkpoints stay in the per-modality format.

``read_flax_checkpoint`` reads the JAX package's per-fold checkpoint
(``cVAE_model.ckpt``, a flax msgpack blob, train/checkpoints.py:54, plus the
``cVAE_model.json`` config sidecar) without jax or flax.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

_LEAF_NAMES = {"weight": "w", "bias": "b"}
# state-dict key prefixes that sit elsewhere in the JAX tree
_PREFIXES = {"classifier.state.": "bn_state."}


def _tree_path(key: str) -> tuple:
    for prefix, jax_prefix in _PREFIXES.items():
        if key.startswith(prefix):
            key = jax_prefix + key[len(prefix):]
    return tuple(int(p) if p.isdigit() else _LEAF_NAMES.get(p, p)
                 for p in key.split("."))


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _listify(node):
    """Dicts keyed 0..n-1 (ints, or the strings flax writes for list
    entries) become lists, recursively."""
    if isinstance(node, dict):
        if "__msgpack_chunked_array__" in node:
            raise ValueError("chunked msgpack arrays (leaves over 1 GiB) are "
                             "not supported")
        keys = [str(k) for k in node]
        if node and sorted(keys) == sorted(str(i) for i in range(len(node))):
            by_index = {int(k): v for k, v in node.items()}
            return [_listify(by_index[i]) for i in range(len(node))]
        return {k: _listify(v) for k, v in node.items()}
    return node


def params_from_jax(tree, model: nn.Module, device=None) -> nn.Module:
    """Load a JAX-layout tree of numpy arrays into ``model`` and move it to
    ``device``. The tree is one fold's (leaves as the JAX package stores
    them, for a model with folds=1) or fold-stacked (every leaf with a
    leading fold axis of the model's size, as ``stack_params`` builds)."""
    state = {}
    for key, param in model.state_dict().items():
        leaf = np.asarray(_get(tree, _tree_path(key)), dtype=np.float32)
        if key.endswith("weight"):
            leaf = np.swapaxes(leaf, -1, -2)
        if leaf.ndim == param.dim() - 1:
            leaf = leaf[None]
        if leaf.shape != tuple(param.shape):
            raise ValueError(f"params_from_jax: {key} has shape {leaf.shape} "
                             f"after layout conversion, the model expects "
                             f"{tuple(param.shape)}")
        state[key] = torch.from_numpy(np.array(leaf, order="C"))
    model.load_state_dict(state, strict=True)
    return model.to(device) if device is not None else model


def params_to_jax(model: nn.Module, fold: Optional[int] = None) -> dict:
    """The model's parameters as a JAX-layout tree of numpy arrays:
    fold-stacked, or only ``fold``'s when it is given. The arrays are a
    copy: the model may train on."""
    flat = {}
    for key, t in model.state_dict().items():
        leaf = t.detach().to("cpu", copy=True).numpy()
        if fold is not None:
            leaf = leaf[fold]
        if key.endswith("weight"):
            leaf = np.swapaxes(leaf, -1, -2)
        flat[_tree_path(key)] = np.ascontiguousarray(leaf)
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
    return _listify(tree)


def classifier_from_jax(params, model: nn.Module, device=None) -> nn.Module:
    """The JAX classifier's list of ``{"w", "b"}`` into ``model``, an
    ``MLPClassifier`` of S configurations: one configuration's list goes
    to every configuration, a list whose leaves carry a leading S axis
    goes configuration by configuration."""
    def fit(leaf, ndim):
        leaf = np.asarray(leaf)
        if leaf.ndim == ndim:
            return np.broadcast_to(leaf, (model.configs,) + leaf.shape)
        return leaf

    tree = {"layers": [{"w": fit(layer["w"], 2), "b": fit(layer["b"], 1)}
                       for layer in params]}
    return params_from_jax(tree, model, device)


def classifier_to_jax(model: nn.Module, config: Optional[int] = None):
    """``model``'s parameters as the JAX classifier's list of ``{"w",
    "b"}``: stacked over the configurations, or only ``config``'s."""
    return params_to_jax(model, config)["layers"]


def packed_from_jax(trees, stacked) -> dict:
    """JAX per-modality trees (a list of one fold's trees, or one
    fold-stacked tree) -> the packed tree of ``stacked``
    (a models.stacked.StackedMultimodalCVAE)."""
    if isinstance(trees, (list, tuple)):
        from .parallel.folds import stack_params

        trees = stack_params(list(trees))
    return stacked.pack_params(trees)


def packed_to_jax(packed: dict, stacked, fold: Optional[int] = None) -> dict:
    """The packed tree -> the per-modality JAX-layout tree of numpy arrays:
    fold-stacked, or only ``fold``'s when it is given."""
    def to_numpy(node):
        if isinstance(node, dict):
            return {k: to_numpy(v) for k, v in node.items()}
        if isinstance(node, list):
            return [to_numpy(v) for v in node]
        leaf = node.detach().cpu().numpy()
        return np.ascontiguousarray(leaf if fold is None else leaf[fold])

    return to_numpy(stacked.unpack_params(packed))


def packed_from_model(model: nn.Module, stacked) -> dict:
    """The fold-stacked MultimodalCVAE's parameters as ``stacked``'s packed
    tree, on the model's device."""
    device = next(model.parameters()).device
    packed = stacked.pack_params(params_to_jax(model))

    def move(node):
        if isinstance(node, dict):
            return {k: move(v) for k, v in node.items()}
        if isinstance(node, list):
            return [move(v) for v in node]
        return node.to(device)

    return move(packed)


def packed_to_model(packed: dict, stacked, model: nn.Module) -> nn.Module:
    """Load a packed tree into the fold-stacked MultimodalCVAE (in place)."""
    return params_from_jax(packed_to_jax(packed, stacked), model)


def _flax_ext_hook(code: int, data: bytes):
    """flax.serialization's msgpack ext types: 1 is an ndarray, 3 a numpy
    scalar, both packed as [shape, dtype name, raw C-order bytes]."""
    import msgpack

    if code not in (1, 3):
        raise ValueError(f"unsupported msgpack ext type {code} in checkpoint")
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    arr = np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode()))
    arr = arr.reshape(shape).copy()
    return arr if code == 1 else arr[()]


def read_flax_checkpoint(fold_dir, name: str = "cVAE_model"
                         ) -> Tuple[dict, dict]:
    """Returns (params tree, model config) of a checkpoint the JAX package
    wrote with train/checkpoints.save_checkpoint (msgpack backend)."""
    import msgpack

    fold_dir = Path(fold_dir)
    config = json.loads((fold_dir / f"{name}.json").read_text())
    blob = (fold_dir / f"{name}.ckpt").read_bytes()
    state = msgpack.unpackb(blob, ext_hook=_flax_ext_hook, raw=False)
    return _listify(state), config
