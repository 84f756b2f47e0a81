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

import contextlib
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


def _declare_encoder(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The entry points of csrc/encoder.cu (also built alone by
    scripts/torch_encoder_tile_probe.py)."""
    ptr = ctypes.c_void_p
    i32 = ctypes.c_int
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    lib.mmnm_encoder.argtypes = [ptr] * 5 + [i32] * 6 + [
        ptrs, ptrs, ctypes.POINTER(ctypes.c_int), i32, i32, i32, ptr]
    lib.mmnm_encoder.restype = i32
    lib.mmnm_encoder_sizes.argtypes = [
        i32, i32, ctypes.POINTER(ctypes.c_longlong)]
    lib.mmnm_encoder_sizes.restype = None
    lib.mmnm_error_string.argtypes = [i32]
    lib.mmnm_error_string.restype = ctypes.c_char_p
    return lib


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr = ctypes.c_void_p
    i32 = ctypes.c_int
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    ints = ctypes.POINTER(ctypes.c_int)
    _declare_encoder(lib)
    lib.mmnm_pred_deviation.argtypes = [ptr] * 6 + [i32] * 6 + [
        ptrs, ptrs, ints, i32, i32, ptr]
    lib.mmnm_pred_deviation.restype = i32
    lib.mmnm_decoder_nll_fwd.argtypes = [ptr] * 9 + [i32] * 5 + [ptr]
    lib.mmnm_decoder_nll_fwd.restype = i32
    lib.mmnm_decoder_nll_bwd.argtypes = ([ptr] * 8 + [i32] + [ptr] * 5
                                         + [i32] * 5 + [ptr])
    lib.mmnm_decoder_nll_bwd.restype = i32
    sizes = ctypes.POINTER(ctypes.c_longlong)
    lib.mmnm_decoder_nll_sizes.argtypes = [i32, sizes]
    lib.mmnm_decoder_nll_sizes.restype = None
    lib.mmnm_pred_deviation_sizes.argtypes = [i32, sizes]
    lib.mmnm_pred_deviation_sizes.restype = None
    lib.mmnm_train_step.argtypes = [ptrs, ints, i32, ptr]
    lib.mmnm_train_step.restype = i32
    lib.mmnm_train_step_workspace.argtypes = [ints, i32]
    lib.mmnm_train_step_workspace.restype = ctypes.c_longlong
    lib.mmnm_train_step_plan.argtypes = [ints, ints]
    lib.mmnm_train_step_plan.restype = i32
    return lib


def load_library() -> ctypes.CDLL:
    """The built kernel library, compiled on first use in this process."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _declare(ctypes.CDLL(str(build_library())))
            _check_mirrored_sizes(lib)
            _lib = lib
        return _lib


def _check_mirrored_sizes(lib: ctypes.CDLL) -> None:
    """The launch plans are computed here, in Python, from tile constants
    that mirror csrc/tile_product.cuh: hold them to what the library
    reports, at a few widths."""
    out = (ctypes.c_longlong * 4)()
    for width in (1, 13, 110, 128, 529):
        lib.mmnm_decoder_nll_sizes(width, out)
        want = [TILE_ROWS, TILE_COLS, decoder_nll_fwd_smem(width),
                decoder_nll_smem(width)]
        if list(out) != want:
            raise RuntimeError(f"decoder_nll.cu reports {list(out)} at width "
                               f"{width}, _build.py expects {want}")
        lib.mmnm_pred_deviation_sizes(width, out)
        want = [TILE_ROWS, TILE_COLS, pred_deviation_smem(width)]
        if list(out)[:3] != want:
            raise RuntimeError(f"pred_deviation.cu reports {list(out)[:3]} at "
                               f"width {width}, _build.py expects {want}")
        for k_per in (TILE_DEPTH, 7 * TILE_DEPTH, 10 * TILE_DEPTH):
            lib.mmnm_encoder_sizes(k_per, width, out)
            want = [TILE_ROWS, TILE_COLS, TILE_DEPTH,
                    encoder_smem(k_per, width)]
            if list(out) != want:
                raise RuntimeError(f"encoder.cu reports {list(out)} at "
                                   f"k_per {k_per}, width {width}, _build.py "
                                   f"expects {want}")


def check_launch(lib: ctypes.CDLL, rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA error {rc}: "
                           f"{lib.mmnm_error_string(rc).decode()}")


# ---- operand checks shared by the wrappers ----------------------------------

# the largest dynamic shared memory an H100 block may use (227 KB), what a
# block may use when two are to share an SM (its 228 KB less the 1 KB the
# system keeps per block, halved), and the kernels' MAX_LAYERS
MAX_SMEM_BYTES = 232448
HALF_SM_SMEM_BYTES = 233472 // 2 - 1024
_MAX_LAYERS = 8

# csrc/tile_product.cuh (encoder.cu, decoder_nll.cu, pred_deviation.cu): a
# block's tile is TILE_ROWS x TILE_COLS, the weights stream in chunks
# TILE_DEPTH deep through a cp.async ring of three slots of [128][32 + 4]
# floats; load_library() holds these to what the library reports
TILE_ROWS = 32
TILE_COLS = 128
TILE_DEPTH = 32
RING_BYTES = 4 * 3 * TILE_COLS * (TILE_DEPTH + 4)
_DMEAN_TILE_BYTES = 4 * TILE_ROWS * (TILE_COLS + 8)
# an H100's SMs, and the blocks of these kernels that share one (256
# threads, at most 128 registers a thread, under half its shared memory at
# the flagship widths): what a launch plan fills
SMS = 132
BLOCKS_PER_SM = 2

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
    input of width k_in (the heads all read the last hidden activation);
    returns each layer's output width. What the widths need of shared
    memory is each kernel's plan to check."""
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
    return widths


def tile_ld(width: int) -> int:
    """Row stride (floats) of a shared-memory activation tile of ``width``
    columns: a multiple of 4 that is 8 mod 16 (tile_product.cuh)."""
    return width + (24 - width % 16) % 16


def decoder_nll_fwd_smem(hidden: int) -> int:
    """Shared memory of csrc/decoder_nll.cu's forward block: the ring, the
    g tile of ``hidden`` columns and the block sum's 256 floats."""
    return RING_BYTES + 4 * (TILE_ROWS * tile_ld(hidden) + 256)


def decoder_nll_smem(hidden: int) -> int:
    """Shared memory of csrc/decoder_nll.cu's largest block (the
    backward): the ring, the g tile of ``hidden`` columns, the dmean tile
    and the column sums."""
    return (RING_BYTES + 4 * TILE_ROWS * tile_ld(hidden) + _DMEAN_TILE_BYTES
            + 4 * 4 * TILE_COLS)


def pred_deviation_smem(widest: int) -> int:
    """Shared memory of csrc/pred_deviation.cu's block: the ring, two
    activation tiles as wide as the widest of the input and the hidden
    layers, and the row sums."""
    return RING_BYTES + 4 * (2 * TILE_ROWS * tile_ld(widest) + 4 * TILE_ROWS)


def encoder_smem(k_per: int, widest: int) -> int:
    """Shared memory of csrc/encoder.cu's block: the ring, a region that
    holds the [32, k_per] slice of [x | c] and later an activation tile,
    and an activation tile, each as wide as the widest hidden layer (1
    without one)."""
    ld = tile_ld(widest)
    return RING_BYTES + 4 * TILE_ROWS * (max(tile_ld(k_per), ld) + ld)


def fill_split(blocks: int, loop: int, unit: float = 0.0,
               least: int = 1) -> int:
    """Into how many blocks to split a loop of ``loop`` steps that each of
    ``blocks`` blocks would walk alone, so that the launch takes the fewest
    block-times: waves of SMS * BLOCKS_PER_SM blocks, each block walking
    ceil(loop / split) steps plus ``unit`` steps of work that every block
    repeats. The smallest such split that is at least ``least``. A launch
    gets at least SMS blocks wherever blocks * loop allows it."""
    slots = SMS * BLOCKS_PER_SM
    least = min(max(least, 1), max(loop, 1))
    return min(range(least, max(loop, 1) + 1),
               key=lambda s: (-(-blocks * s // slots) * (-(-loop // s) + unit),
                              s))


def current_device_guard(device: torch.device):
    """``torch.cuda.device(device)``, or nothing when ``device`` is
    already the current one (the guard costs more than a launch's other
    host work)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def launch_args(layers: Sequence[Layer], widths: Sequence[int]):
    """ctypes arrays of the layers' weight and bias pointers and widths."""
    n = len(layers)
    w = (ctypes.c_void_p * n)(*[lw.data_ptr() for lw, _ in layers])
    b = (ctypes.c_void_p * n)(*[lb.data_ptr() for _, lb in layers])
    return w, b, (ctypes.c_int * n)(*widths)


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
