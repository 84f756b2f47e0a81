"""Readings that the limits of ``correct`` are set from, in one process.

    python3 perfbench/calibrate.py --workload <name> --seeds 12 \
        --control-seeds 3 [--first-seed N] [--seconds S]

For each seed: the cell's set-up, its warm-up and a short window of the
program, then each compared number of the program against the reference
(the lower readings). On the first ``--control-seeds`` seeds also the
control, the reference computed in TF32 put in the program's place, the
reference with half of every batch left out (a fault) and with steps that
leave the parameters as they were (another); their readings give the
upper ones. One JSON line a reading. The benchmark's runs do not run
this; PERF.md keeps what it read.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--first-seed", type=int, default=2**31 + 1000)
    parser.add_argument("--seconds", type=float, default=0.5)
    args = parser.parse_args(argv)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, str(ROOT))

    import torch

    from perfbench import harness, spec
    from perfbench.reference.cvae import Reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = spec.load_benchmark()
    entry = spec.workload(bench, args.workload)
    cfg = spec.config(bench, entry["config"])
    mix = spec.traffic(entry["traffic"])
    stand_ins = {"control_tf32": Reference(cfg, tf32=True),
                 "fault_half_batch": Reference(cfg, half_batch=True),
                 "fault_unchanged": Reference(cfg, frozen=True)}
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        cell = spec.generator(mix)(cfg, mix, seed, "cuda")
        cell.warm()
        harness.run_window(cell, args.seconds)
        outputs = cell.take_outputs()
        numbers = tuple(spec.limits(args.workload))
        readings = {"program": cell.check(outputs, numbers, detail=True)}
        if i < args.control_seeds:
            for kind, ref in stand_ins.items():
                readings[kind] = cell.check(outputs, numbers, stand_in=ref,
                                              detail=True)
        for kind, found in readings.items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "kind": kind, "checked": len(outputs),
                              **found}), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
        del cell, outputs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
