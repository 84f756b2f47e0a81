"""Per-fold checkpoint writer (counterpart of train/checkpoints.py, msgpack
backend).

Writes ``cVAE_model.ckpt``, the byte format of flax.serialization.to_bytes
(the JAX package's save_checkpoint), with msgpack alone, plus the
``cVAE_model.json`` model-config sidecar, so the JAX test stage and the
port's (``interop.read_flax_checkpoint``) both restore it. The tree is one
fold's parameters in the JAX layout (``interop.params_to_jax(model, fold)``).

The train-state half (``save_train_state``, ``load_train_state``,
``run_chunked``) keeps a whole run's resumable state, ``train_state.ckpt``,
in the same msgpack format; its tensors are the port's own (MaskedAdam,
torch generators), so it resumes only runs of this package.
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


def checkpoint_exists(directory, name: str = "cVAE_model") -> bool:
    """Whether ``directory`` holds a checkpoint the port can read (the
    msgpack ``name``.ckpt; the JAX package also reads an orbax directory,
    which the port does not)."""
    return (Path(directory) / f"{name}.ckpt").exists()


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


# ---- mid-run train state (train/checkpoints.py:125-287) --------------------
# One blob holds the epoch cursor, the logs so far, the trajectory
# fingerprint and the tensors (MaskedAdam's flat parameters, moments and
# step counts, every fold's noise generator, the model's non-gradient
# buffers), written atomically (a pid-suffixed tmp file, then os.replace):
# a kill at any instant leaves the previous state whole, cursor and tensors
# together. The .json sidecar is informational only.

# marks a state this package wrote; the JAX package's states (threefry keys,
# optax moments) carry none and cannot be continued here
TRAIN_STATE_FORMAT = "mmnm-torch-train-state/1"


def _json_bytes(obj) -> np.ndarray:
    """A JSON value as a uint8 array (the blob's leaves are arrays)."""
    return np.frombuffer(json.dumps(obj, sort_keys=True).encode(),
                         dtype=np.uint8).copy()


def _json_value(arr):
    return json.loads(bytes(np.asarray(arr, dtype=np.uint8)).decode())


def save_train_state(directory, tensors: dict, epoch: int, logs=None,
                     name: str = "train_state",
                     meta: "dict | None" = None) -> Path:
    """Writes ``name``.ckpt: ``tensors`` (a tree of numpy arrays), the epoch
    cursor, ``logs`` ({key: [F, epoch]}) and ``meta``, the flat str->str
    fingerprint of the run's numerics that a resume must repeat."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    blob = to_bytes({
        "format": _json_bytes(TRAIN_STATE_FORMAT),
        "tensors": tensors,
        "epoch": np.int64(epoch),
        "meta": _json_bytes({str(k): str(v)
                             for k, v in (meta or {}).items()}),
        "logs": dict(logs) if logs is not None else {},
    })
    tmp = directory / f".{name}.ckpt.{os.getpid()}.tmp"
    tmp.write_bytes(blob)
    os.replace(tmp, directory / f"{name}.ckpt")
    (directory / f"{name}.json").write_text(json.dumps({"epoch": int(epoch)}))
    return directory / f"{name}.ckpt"


def _read_train_state(directory, name: str) -> dict:
    """The blob's tree; refuses one this package did not write."""
    import msgpack

    from ..interop import _flax_ext_hook, _listify

    path = Path(directory) / f"{name}.ckpt"
    raw = _listify(msgpack.unpackb(path.read_bytes(),
                                   ext_hook=_flax_ext_hook, raw=False))
    stored = raw.get("format") if isinstance(raw, dict) else None
    if stored is None or _json_value(stored) != TRAIN_STATE_FORMAT:
        origin = ""
        if isinstance(raw, dict) and {"opt_state", "key"} <= set(raw):
            origin = (" (it is the JAX package's train state: its PRNG keys "
                      "are threefry's and its optimizer state optax's, "
                      "which this package cannot continue)")
        raise ValueError(
            f"refusing to resume {Path(directory)}: {path.name} was not "
            f"written by the torch port{origin}. Delete the state to "
            "restart fresh.")
    return raw


def load_train_state(directory, name: str = "train_state"):
    """Returns (tensors, epoch, logs) of a state ``save_train_state``
    wrote."""
    raw = _read_train_state(directory, name)
    logs = raw.get("logs") or None
    return raw["tensors"], int(np.asarray(raw["epoch"])), logs


def peek_train_meta(directory, name: str = "train_state"):
    """The stored trajectory fingerprint (None when it is empty)."""
    return _json_value(_read_train_state(directory, name)["meta"]) or None


def train_state_exists(directory, name: str = "train_state") -> bool:
    return (Path(directory) / f"{name}.ckpt").exists()


def run_chunked(state_dir, total_epochs: int, checkpoint_every: int,
                resume: bool, session, meta: "dict | None" = None):
    """The chunked loop behind every trainer's run_resumable: with
    ``resume`` and a state under ``state_dir``, restore ``session``
    (train.trainer.TrainSession) from it, then advance it
    ``checkpoint_every`` epochs at a time to ``total_epochs``, saving the
    state after every chunk. Chunks continue the one trajectory, so the
    result equals a run without checkpoints bit for bit.

    A resume whose fingerprint ``meta`` differs from the stored one is
    refused: continuing under other numerics would give a trajectory that
    matches neither configuration."""
    if checkpoint_every <= 0:
        raise ValueError(
            f"checkpoint_every must be >= 1, got {checkpoint_every}")
    if resume and train_state_exists(state_dir):
        stored_meta = peek_train_meta(state_dir)
        want = {str(k): str(v) for k, v in (meta or {}).items()}
        if (stored_meta or {}) != want:
            raise ValueError(
                f"refusing to resume {state_dir}: the stored train state "
                f"was written under {stored_meta}, but this run is "
                f"configured as {want} — a mixed-numerics trajectory would "
                "match neither config. Re-launch with the original flags "
                "(e.g. --no_fused_heads / --precision) or delete the state "
                "to restart fresh.")
        session.restore(*load_train_state(state_dir))
    while session.epoch < total_epochs:
        session.advance(min(checkpoint_every, total_epochs - session.epoch))
        save_train_state(state_dir, session.state(), session.epoch,
                         session.logs(), meta=meta)
    return session
