"""Finds everything of a cell by name.

``BENCHMARK.json`` (at the checkout's root) names the cell's configuration
and traffic mix; the rest is files under ``perfbench/``:

    configs/<config>.json     the model and the job (the entry's ``file``)
    traffic/<mix>.json        the mix's parameters; its ``generator``
                              names the general generator that reads them
                              (``perfbench/generators/<generator>.py``)
    limits/<workload>.json    each compared number's limit, for the cell
    metrics/<metric>.py       one reader a metric, end-to-end or per layer:
                              ``read(ctx)`` returns the value, or None
                              where it finds nothing to read. A metric
                              ``<base>.<part>`` without a file of its own
                              is read by ``metrics/<base>.py``: one reader
                              serves the quantity split by cells.

BENCHMARK.json alone decides which metrics a cell reports (an entry's
``workloads``). A new configuration, mix, cell or metric is new files and
new entries.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark() -> dict:
    path = ROOT / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path}: no benchmark file")
    return json.loads(path.read_text())


def _entry(entries: List[dict], name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    return _entry(bench["workloads"], name, "workload")


def config(bench: dict, name: str) -> dict:
    entry = _entry(bench["configs"], name, "configuration")
    return json.loads((ROOT / entry["file"]).read_text())


def _data(folder: str, name: str) -> dict:
    path = HERE / folder / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path}: not found")
    return json.loads(path.read_text())


def traffic(name: str) -> dict:
    return _data("traffic", name)


def limits(workload_name: str) -> Dict[str, float]:
    return _data("limits", workload_name)


def generator(mix: dict):
    """The generator class the mix names: generators/<generator>.py."""
    return importlib.import_module(
        f"perfbench.generators.{mix['generator']}").Generator


def reader_path(metric: str) -> Path:
    """metrics/<metric>.py, else metrics/<base>.py for ``<base>.<part>``."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.is_file() and "." in metric:
        path = HERE / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path}: no reader for {metric!r}")
    return path


def reader(metric: str) -> Callable:
    """``read(ctx)`` of the metric's reader (metric names hold dots, so the
    file is loaded by its path)."""
    path = reader_path(metric)
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(bench: dict, workload_name: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer ones (on):
    those with no ``workloads`` list and those whose list names it."""
    entries = bench["per_layer" if trace else "end_to_end"]
    return [m for m in entries
            if workload_name in m.get("workloads", [workload_name])]


def read_metrics(entries: List[dict], ctx) -> Dict[str, dict]:
    """{name: {value, unit}} of every metric whose reader found something
    to read; each that found nothing is named on standard error and left
    out of the line."""
    out = {}
    for entry in entries:
        value: Optional[float] = reader(entry["name"])(ctx)
        if value is None:
            print(f"perfbench: {entry['name']} found nothing to read",
                  file=sys.stderr)
            continue
        out[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    return out
