"""One run of one cell: set-up, warm-up, the measured window, in a traced
run the profiled sub-window, then the comparison that decides
``correct``, and the result line.

The window runs the generator's items (jobs) one after another until
``seconds`` have passed, and finishes the item in flight. An item that
raises counts as failed and adds no work. The window's outputs are held;
once it has closed (and the traced sub-window has run), the device's
memory peak is read, the program is let go, and the reference is run on
a sample of the held outputs drawn from the seed.
"""
from __future__ import annotations

import dataclasses
import sys
import time
import traceback
from typing import Dict, List, Optional

from . import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "optax",
             "multi_modal_normative_modeling_tpu")


@dataclasses.dataclass
class Window:
    attempted: int = 0
    failed: int = 0
    elapsed_s: float = 0.0
    units: int = 0          # steps completed
    samples: int = 0        # fold-samples trained


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""
    workload: str
    setup_s: float
    window: Window
    unit_work: object       # work.Work of one unit
    unit_model_flops: float
    trace: object = None    # devtrace.Trace of the traced sub-window
    traced_units: int = 0


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the port may not load, each
    compared whole."""
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


def run_window(cell, seconds: float) -> Window:
    win = Window()
    cell.holding = True
    t0 = time.perf_counter()
    k = 0
    while True:
        try:
            cell.item(k)
            win.units += cell.units_of(1)
            win.samples += cell.samples_of(1)
        except Exception:  # an item that fails is counted, the run goes on
            traceback.print_exc(file=sys.stderr)
            win.failed += 1
        win.attempted += 1
        k += 1
        if time.perf_counter() - t0 >= seconds:
            break
    win.elapsed_s = time.perf_counter() - t0
    cell.holding = False
    return win


def run_cell(workload_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             bench: Optional[dict] = None, cfg: Optional[dict] = None,
             mix: Optional[dict] = None,
             limits: Optional[Dict[str, float]] = None) -> dict:
    """The result of one run (the last line's object). ``bench``, ``cfg``,
    ``mix`` and ``limits`` default to the files the names lead to."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    bench = spec.load_benchmark() if bench is None else bench
    entry = spec.workload(bench, workload_name)
    cfg = spec.config(bench, entry["config"]) if cfg is None else cfg
    mix = spec.traffic(entry["traffic"]) if mix is None else mix
    limits = spec.limits(workload_name) if limits is None else limits
    cuda = torch.device(device).type == "cuda"

    t_cell = time.perf_counter()
    cell = spec.generator(mix)(cfg, mix, seed, device)
    t_warm = time.perf_counter()
    cell.warm()                                 # every shape the window runs
    if cuda:
        torch.cuda.synchronize()
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    print(f"set-up {setup_s:.3f} s: the interpreter, torch and the GPU "
          f"check {t_cell - t_start:.3f} s, the port's imports, the card's "
          f"context, the inputs and the program's objects "
          f"{t_warm - t_cell:.3f} s, the warm-up {t_window - t_warm:.3f} s",
          file=sys.stderr)

    win = run_window(cell, seconds)
    ctx = Context(workload_name, setup_s, win,
                  cell.unit_work(), cell.unit_model_flops())
    if trace:
        from . import devtrace

        per_item = cell.units_of(1)
        items = max(1, -(-mix["trace_units"] // per_item))
        start = win.attempted
        ctx.trace = devtrace.capture(
            lambda: [cell.item(start + i) for i in range(items)])
        ctx.traced_units = cell.units_of(items)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0

    outputs = cell.take_outputs()
    if cuda:
        torch.cuda.empty_cache()
    numbers = cell.check(outputs, tuple(limits))
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = (win.failed == 0 and len(outputs) > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))

    result = {
        "correct": correct,
        "attempted": win.attempted,
        "failed": win.failed,
        "metrics": spec.read_metrics(
            spec.metrics_of(bench, workload_name, trace), ctx),
        "device": device_info(device, memory_peak, ctx.trace),
    }
    if trace:
        result["breakdown"] = {"device_ops": ctx.trace.device_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    result["checks"] = checks
    return result


def device_info(device: str, memory_peak: int, trace) -> dict:
    import torch

    if torch.device(device).type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = int(memory_peak)
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info
