"""Profiling and timing (counterpart of utils/profiling.py).

* ``trace(log_dir)``  a ``torch.profiler.profile`` around a region, with
                      CPU activity and, when a card is present, CUDA
                      activity; it writes a Chrome-trace JSON under
                      ``log_dir`` (Perfetto and TensorBoard's profiler
                      plugin read it; its path is ``trace.last``). Asked
                      for CUDA activity where there is none, it raises: a
                      device trace is never silently a host-only one.
* ``annotate(name)``  a named region on the host timeline
                      (``torch.profiler.record_function``).
* ``Timer``/``timed`` wall-clock timing with warm-up, completion forced by
                      ``torch.cuda.synchronize()`` on the card, or a host
                      copy of the last tensor of the result on the CPU;
                      the same return dicts as the JAX package's.
"""
from __future__ import annotations

import contextlib
import os
import socket
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir, cuda: Optional[bool] = None):
    """Profile the region into a Chrome trace under ``log_dir``. ``cuda``
    (default: whether a card is there) adds the device's activity; True
    without a card raises. The written path is ``trace.last``."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("trace(cuda=True): no CUDA device is available")
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        # one file a run, named after the host and the process
        path = Path(log_dir) / (f"{socket.gethostname()}.{os.getpid()}."
                                f"{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(str(path))
        trace.last = path


trace.last = None


def annotate(name: str):
    """A named region on the profiler's host timeline."""
    return torch.profiler.record_function(name)


def _last_tensor(value):
    if isinstance(value, torch.Tensor):
        return value
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        for item in reversed(value):
            found = _last_tensor(item)
            if found is not None:
                return found
    return None


def _force(value):
    """Force the work behind ``value`` to completion: synchronize the card,
    or copy the last tensor of the result to the host."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    else:
        last = _last_tensor(value)
        if last is not None:
            np.asarray(last.detach().cpu())
    return value


class Timer:
    """Median-of-k wall-clock timer with warm-up, completion-forced."""

    def __init__(self, warmup: int = 1, repeats: int = 3):
        self.warmup = warmup
        self.repeats = repeats

    def measure(self, fn: Callable, *args, **kwargs) -> dict:
        for _ in range(self.warmup):
            _force(fn(*args, **kwargs))
        times = []
        for _ in range(self.repeats):
            t0 = time.perf_counter()
            _force(fn(*args, **kwargs))
            times.append(time.perf_counter() - t0)
        return {
            "median_s": float(np.median(times)),
            "min_s": float(np.min(times)),
            "times_s": times,
        }


def timed(fn: Callable, *args, warmup: int = 1, repeats: int = 3, **kwargs):
    """(result, stats) for one measured call after warm-up."""
    timer = Timer(warmup=warmup, repeats=repeats)
    stats = timer.measure(fn, *args, **kwargs)
    return fn(*args, **kwargs), stats
