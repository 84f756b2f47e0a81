"""Loss history logging and plotting (utils_vae.py:114-145 equivalents) plus a
structured JSONL run log for observability."""
from __future__ import annotations

import json
import time
from os.path import join
from pathlib import Path

import numpy as np


class Logger:
    """Dict-of-lists loss history (utils_vae.py:134-145)."""

    def __init__(self):
        self.logs = {}

    def on_train_init(self, keys):
        for k in keys:
            self.logs[k] = []

    def on_step_fi(self, logs_dict):
        for k, v in logs_dict.items():
            self.logs[k].append(np.asarray(v))

    def extend(self, logs_dict):
        """Bulk-append per-epoch arrays (the jitted trainer returns the whole
        history at once)."""
        for k, v in logs_dict.items():
            self.logs.setdefault(k, [])
            self.logs[k].extend(np.asarray(v).tolist())


def plot_losses(logger: Logger, path, title: str = "") -> None:
    """Two-panel (absolute + max-normalized) loss-curve PNG, saved as
    ``Losses<title>.png`` (utils_vae.py:114-132).

    Uses the object-oriented Agg canvas instead of pyplot: no global figure
    registry, ~2x faster per figure, and safe to call concurrently (pyplot's
    implicit state is process-global)."""
    from matplotlib.figure import Figure

    fig = Figure()
    ax1 = fig.add_subplot(1, 2, 1)
    ax1.set_title("Loss values")
    for k, v in logger.logs.items():
        ax1.plot(v, label=str(k))
    ax1.set_xlabel("epochs", fontsize=10)
    ax1.set_ylabel("loss", fontsize=10)
    ax1.legend()
    ax2 = fig.add_subplot(1, 2, 2)
    ax2.set_title("Loss relative values")
    for k, v in logger.logs.items():
        max_loss = 1e-8 + np.max(np.abs(v))
        ax2.plot(np.asarray(v) / max_loss, label=str(k))
    ax2.legend()
    ax2.set_xlabel("epochs", fontsize=10)
    ax2.set_ylabel("loss", fontsize=10)
    fig.savefig(join(str(path), "Losses{0}.png".format(title)))


class RunLog:
    """Append-only JSONL event log (one file per run directory)."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def event(self, kind: str, **fields) -> None:
        record = {"t": time.time(), "event": kind}
        record.update(fields)
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=str) + "\n")
