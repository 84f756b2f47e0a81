"""Every cell, run as the benchmark runs it, on the card: a short traced
run comes out correct with its per-layer metrics and its breakdown."""
import json
import subprocess
import sys

import pytest
import torch

from perfbench import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          cell, "--seed", str(2**31 + 17), "--seconds", "1",
                          "--trace", "1"], capture_output=True, text=True,
                         timeout=600, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    want = {m["name"] for m in spec.metrics_of(spec.load_benchmark(), cell,
                                               True)}
    assert set(result["metrics"]) == want
    for name, m in result["metrics"].items():
        if "roofline" in name or "mfu" in name:
            assert 0 < m["value"] <= 100
    assert result["breakdown"]["device_ops"]
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
