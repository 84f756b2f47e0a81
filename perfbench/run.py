"""Run one cell of the benchmark of multi_modal_normative_modeling_tpu_torch.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with an NVIDIA GPU. Prints, as
the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit
(also the last lines of standard error). Exits with another code than 0,
printing no result, where there is no GPU, and where a module of JAX or of
the JAX package was loaded.

Build and kernel caches go to fixed directories inside the checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".perfbench_cache"


def parse(argv):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    # run from the checkout: the port and perfbench by their full names
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, str(ROOT))

    import torch

    from perfbench import harness, spec

    entry = spec.workload(spec.load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device; a run needs the GPU",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < entry["chips"]:
        print(f"perfbench: {args.workload} needs {entry['chips']} GPU(s), "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
