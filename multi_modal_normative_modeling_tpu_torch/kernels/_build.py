"""Build, load and call the port's CUDA kernels.

nvcc compiles every ``csrc/*.cu`` into one shared library with a plain C
interface: ``extern "C"`` launchers that take raw device pointers and the
current ``cudaStream_t`` and return ``cudaGetLastError()`` after the
launch. The library is built on first use into ``kernels/_build/``, keyed
by a hash of the sources and flags, and loaded with ctypes: one nvcc per
source, all started together, then one link. The ptxas report (registers,
shared memory, spills) is kept beside it as a ``.log``.

Any build, load or launch error raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Sequence, Tuple

import torch

SRC_DIR = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = ("-O3", "-std=c++17", "-Xcompiler", "-fPIC",
              "-gencode", "arch=compute_90a,code=sm_90a", "-Xptxas", "-v")

_lib = None
_lib_lock = threading.Lock()


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, else from PATH, else the toolkit's default
    install prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path() -> Path:
    sources = sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libmmnm_kernels_{digest.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile the sources unless the hashed library already exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # pid-unique tmp names: concurrent cold builds never publish a partial
    # file
    tag = f"building.{os.getpid()}"
    tmp = out.with_suffix(f".{tag}.so")
    objects = [out.with_suffix(f".{src.stem}.{tag}.o")
               for src in sorted(SRC_DIR.glob("*.cu"))]
    compiles = [[nvcc_path(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for obj, src in zip(objects, sorted(SRC_DIR.glob("*.cu")))]
    link = [nvcc_path(), "-shared", "-o", str(tmp), *map(str, objects)]
    log = []
    procs = []

    def finish(cmd, proc):
        text, _ = proc.communicate()
        log.append(text)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{text}")

    def start(cmd):
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
        return procs[-1]

    try:
        for proc, cmd in [(start(cmd), cmd) for cmd in compiles]:
            finish(cmd, proc)
        finish(link, start(link))
        out.with_suffix(".log").write_text("".join(log))
        os.replace(tmp, out)
    finally:
        for proc in procs:  # after a failure, let the others end first
            if proc.returncode is None:
                proc.communicate()
        for path in [tmp, *objects]:
            path.unlink(missing_ok=True)
    return out


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr = ctypes.c_void_p
    i32 = ctypes.c_int
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    ints = ctypes.POINTER(ctypes.c_int)
    lib.mmnm_encoder.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
                                 i32, ptrs, ptrs, ints, i32, ptr]
    lib.mmnm_encoder.restype = i32
    lib.mmnm_pred_deviation.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32,
                                        i32, i32, i32, i32, ptrs, ptrs, ints,
                                        i32, ptr]
    lib.mmnm_pred_deviation.restype = i32
    lib.mmnm_decoder_nll_fwd.argtypes = [ptr] * 9 + [i32] * 5 + [ptr]
    lib.mmnm_decoder_nll_fwd.restype = i32
    lib.mmnm_decoder_nll_bwd.argtypes = [ptr] * 16 + [i32] * 6 + [ptr]
    lib.mmnm_decoder_nll_bwd.restype = i32
    lib.mmnm_train_step.argtypes = [ptrs, ints, i32, ptr]
    lib.mmnm_train_step.restype = i32
    lib.mmnm_train_step_workspace.argtypes = [ints, i32]
    lib.mmnm_train_step_workspace.restype = ctypes.c_longlong
    lib.mmnm_train_step_plan.argtypes = [ints, ints]
    lib.mmnm_train_step_plan.restype = i32
    lib.mmnm_error_string.argtypes = [i32]
    lib.mmnm_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """The built kernel library, compiled on first use in this process."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(build_library())))
        return _lib


def check_launch(lib: ctypes.CDLL, rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA error {rc}: "
                           f"{lib.mmnm_error_string(rc).decode()}")


# ---- operand checks shared by the wrappers ----------------------------------

# the largest dynamic shared memory an H100 block may use (227 KB), and the
# tile constants of csrc/tile_mlp.cuh that set a CTA's use of it: TM rows,
# BN columns, sizeof(mmnm::Stage), MAX_LAYERS
MAX_SMEM_BYTES = 232448
TM = 32
BN = 64
_STAGE_BYTES = 4 * (TM * 33 + 32 * 65)
_MAX_LAYERS = 8

Layer = Tuple[torch.Tensor, torch.Tensor]


def check_tensors(kernel: str, tensors: Sequence[torch.Tensor],
                  device: torch.device) -> None:
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{kernel}: operand on {t.device}, "
                             f"expected {device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{kernel}: operand dtype {t.dtype}, "
                             "expected torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: operands must be contiguous")


def check_rows(kernel: str, name: str, t: torch.Tensor, folds: int,
               rows: int) -> int:
    """Checks t is [folds, rows, width]; returns width."""
    if t.dim() != 3 or t.shape[0] != folds or t.shape[1] != rows:
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"expected [{folds}, {rows}, width]")
    return t.shape[2]


def chain_widths(kernel: str, layers: Sequence[Layer], k_in: int,
                 n_hidden: int, folds: int) -> List[int]:
    """Checks that fold-stacked layers (w [F, n, k], b [F, n]) chain from an
    input of width k_in (the heads all read the last hidden activation) and
    fit the kernel's shared memory; returns each layer's output width."""
    widths = []
    k = k_in
    for l, (w, b) in enumerate(layers):
        if w.dim() != 3 or w.shape[0] != folds or w.shape[2] != k:
            raise ValueError(f"{kernel}: layer {l} weight has shape "
                             f"{tuple(w.shape)}, expected [{folds}, n, {k}]")
        if tuple(b.shape) != (folds, w.shape[1]):
            raise ValueError(f"{kernel}: layer {l} bias has shape "
                             f"{tuple(b.shape)}, expected "
                             f"[{folds}, {w.shape[1]}]")
        widths.append(int(w.shape[1]))
        if l < n_hidden:
            k = widths[-1]
    if len(layers) > _MAX_LAYERS:
        raise ValueError(f"{kernel}: at most {_MAX_LAYERS} layers, got "
                         f"{len(layers)}")
    widest = max(widths[:n_hidden], default=1)
    smem = _STAGE_BYTES + 2 * TM * widest * 4
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{kernel}: hidden width {widest} needs {smem} B of "
                         f"shared memory, over the {MAX_SMEM_BYTES} B limit")
    return widths


def decoder_nll_smem(hidden: int) -> int:
    """Shared memory of csrc/decoder_nll.cu's largest block (the dW pass):
    the stage, two dmean-sized tiles and a g tile plus a dW tile of
    ``hidden`` columns."""
    return _STAGE_BYTES + 4 * (2 * TM * (BN + 1) + (TM + BN) * hidden)


def launch_args(layers: Sequence[Layer], widths: Sequence[int]):
    """ctypes arrays of the layers' weight and bias pointers and widths."""
    n = len(layers)
    w = (ctypes.c_void_p * n)(*[lw.data_ptr() for lw, _ in layers])
    b = (ctypes.c_void_p * n)(*[lb.data_ptr() for _, lb in layers])
    return w, b, (ctypes.c_int * n)(*widths)


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
