"""Per-fold checkpoint writer (counterpart of train/checkpoints.py, msgpack
backend).

Writes ``cVAE_model.ckpt``, the byte format of flax.serialization.to_bytes
(the JAX package's save_checkpoint), with msgpack alone, plus the
``cVAE_model.json`` model-config sidecar, so the JAX test stage and the
port's (``interop.read_flax_checkpoint``) both restore it. The tree is one
fold's parameters in the JAX layout (``interop.params_to_jax(model, fold)``).
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

# flax's msgpack extension type of an ndarray, and the leaf size above which
# flax splits a leaf into chunks (not written here)
_EXT_NDARRAY = 1
_MAX_LEAF_BYTES = 2 ** 30


def _state_dict(node):
    """The tree as flax's to_state_dict leaves it after jax's tree_map:
    dicts with their keys sorted, lists as dicts keyed "0", "1", ..."""
    if isinstance(node, dict):
        return {str(k): _state_dict(node[k]) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(node)}
    arr = np.asarray(node)
    if arr.nbytes > _MAX_LEAF_BYTES:
        raise ValueError(f"checkpoint leaf of {arr.nbytes} bytes: leaves "
                         "over 1 GiB are not supported")
    return arr


def _ext_pack(obj):
    import msgpack

    if isinstance(obj, np.ndarray):
        payload = msgpack.packb((obj.shape, obj.dtype.name, obj.tobytes("C")),
                                use_bin_type=True)
        return msgpack.ExtType(_EXT_NDARRAY, payload)
    raise TypeError(f"cannot serialize {type(obj).__name__} in a checkpoint")


def to_bytes(params) -> bytes:
    """flax.serialization.to_bytes of a tree of numpy leaves."""
    import msgpack

    return msgpack.packb(_state_dict(params), default=_ext_pack,
                         strict_types=True)


def save_checkpoint(directory, params, model_config: dict,
                    name: str = "cVAE_model") -> Path:
    """Writes ``name``.json, then ``name``.ckpt, each atomically (a tmp
    file, then os.replace), as train/checkpoints.py:42-58 does: a reader
    that gates on the .ckpt never sees a missing or truncated json."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    jtmp = directory / f".{name}.json.{os.getpid()}.tmp"
    jtmp.write_text(json.dumps(model_config, indent=1))
    os.replace(jtmp, directory / f"{name}.json")
    tmp = directory / f".{name}.ckpt.{os.getpid()}.tmp"
    tmp.write_bytes(to_bytes(params))
    os.replace(tmp, directory / f"{name}.ckpt")
    return directory / f"{name}.ckpt"
