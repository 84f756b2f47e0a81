"""The device trace of a short steady sub-window, and what is read from it.

``capture(fn)`` runs ``fn`` under torch.profiler (CPU and CUDA activities)
inside a ``perfbench.window`` range, saves the Chrome trace the profiler
writes into a temporary directory, reads it and deletes it. ``Trace``
holds the window's device activities (kernels, copies, sets) and the host
events of the thread that ran the window:

  * ``kernels``   the number of kernels launched in the window
  * ``busy_s``    the union of the device activities
  * ``window_s``  the window's length
  * ``device_ops``  the device operations by their summed time
  * ``idle_gaps``   the device's idle time, summed by what the host was
                    doing (the innermost host event at each gap's middle,
                    under the innermost ``perfbench.*`` range around it)
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, List, Tuple

WINDOW = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
NAME_CHARS = 160


def capture(fn: Callable[[], None]) -> "Trace":
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="perfbench_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return Trace(events)


class Trace:
    def __init__(self, events: List[dict]):
        window = [e for e in events if e.get("name") == WINDOW
                  and e.get("cat") == "user_annotation"]
        if len(window) != 1:
            raise ValueError(f"{len(window)} {WINDOW} ranges in the trace")
        w = window[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.device = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
             e.get("name", ""), e["cat"])
            for e in events if e.get("ph") == "X"
            and e.get("cat") in DEVICE_CATS
            and self.t0 <= float(e["ts"]) <= self.t1)
        self.host = sorted(
            ((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
              e.get("name", ""), e["cat"])
             for e in events if e.get("ph") == "X"
             and e.get("cat") in HOST_CATS
             and e.get("pid") == w.get("pid") and e.get("tid") == w.get("tid")
             and float(e["ts"]) < self.t1
             and float(e["ts"]) + float(e.get("dur", 0.0)) > self.t0),
            key=lambda e: (e[0], -e[1]))

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def kernels(self) -> int:
        return sum(1 for e in self.device if e[3] == "kernel")

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for start, end, _, _ in self.device:
            end = min(end, self.t1)
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def device_ops(self, top: int = 10) -> List[list]:
        total = defaultdict(float)
        for start, end, name, _ in self.device:
            total[name[:NAME_CHARS]] += (end - start) * 1e-6
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def gaps(self) -> List[Tuple[float, float]]:
        out, at = [], self.t0
        for a, b in self.busy_intervals():
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if self.t1 > at:
            out.append((at, self.t1))
        return out

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle seconds summed by what the host was doing."""
        gaps = sorted(self.gaps(), key=lambda g: g[0] + g[1])
        total = defaultdict(float)
        stack: List[tuple] = []
        i = 0
        for a, b in gaps:
            mid = 0.5 * (a + b)
            while i < len(self.host) and self.host[i][0] <= mid:
                event = self.host[i]
                while stack and stack[-1][1] < event[0]:
                    stack.pop()
                stack.append(event)
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            total[_label(stack)] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:top]]


def _label(stack: List[tuple]) -> str:
    """The innermost perfbench range and the innermost host event inside
    it (the stack runs outermost to innermost)."""
    inner = stack[-1][2] if stack else "nothing"
    outer = next((e[2] for e in reversed(stack)
                  if e[2].startswith("perfbench.") and e[2] != WINDOW), "")
    if not outer or outer == inner:
        return inner[:NAME_CHARS]
    return f"{outer}: {inner}"[:NAME_CHARS]
