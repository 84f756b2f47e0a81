#!/usr/bin/env python3
"""Measure the port's fused train step (K5, K6) on one NVIDIA GPU.

    python3 scripts/torch_step_profile.py check     # build, ptxas report,
                                                    # K5/K6 against plain
    python3 scripts/torch_step_profile.py routes    # fused against wide route
    python3 scripts/torch_step_profile.py profile   # training steps under
                                                    # torch.profiler

``check`` compiles the kernels, prints the ptxas register and spill report
of the train step's kernels and holds K5 (both routes) and K6 (fp32 and
bf16) against the plain versions at a ragged-width shape, the flagship and
PPMI width. ``routes`` times one K5 and one K6 bf16 step by CUDA events with
the route forced to fused, to wide aiming at 264 and at 528 blocks, and
left to the kernel's own rule, beside each shape's bound. ``profile`` trains
the flagship (5 folds x 512 subjects, 20 steps) and PPMI width (one fold x
2500 subjects, 10 steps) through FusedFoldTrainer, once timed by the host
clock and once under torch.profiler: ms per step, device kernels per step,
device busy time and share, and the device time of each kernel by name.

Every line of output names what it measured; the first line is the card's
name and power limit. Shapes and helpers are chip_smoke.py's.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from multi_modal_normative_modeling_tpu_torch.kernels import (  # noqa: E402
    _build,
    roofline,
)
from multi_modal_normative_modeling_tpu_torch.kernels import (  # noqa: E402
    train_step as ts,
)
from multi_modal_normative_modeling_tpu_torch.kernels.train_step_tiled import (  # noqa: E402,E501
    TiledFusedTrainStep,
)

RAGGED = ("ragged widths", [37, 90, 271], [110, 110], 2, 100, 29, 10, "gpoe")
SHAPES = {
    "ragged": RAGGED,
    "ragged c2": ("ragged c2", [37, 90, 271], [110, 110], 2, 75, 2, 10,
                  "poe"),
    "flagship": cs.STEP_SHAPES[0],
    "PPMI": cs.STEP_SHAPES[-1],
}
ROUTES = {"auto": 0, "fused": 1, "wide 264": 264, "wide 528": 528}


def card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def problem(shape, cls=ts.FusedTrainStep, **kw):
    name, dims, hidden, folds, rows, c_dim, z_dim, combine = shape
    stacked, packed, x, c, eps, mask = cs.step_problem(
        dims, hidden, folds, rows, c_dim, z_dim, seed=len(name) + rows)
    step = cls(stacked, combine, **kw)
    named = step.pad_params(packed)
    xx, cc, rm, nv = step.pack_batch(x, c, mask)
    return step, named, (xx, cc, step.pad_eps(eps), rm, nv)


def work_of(shape, bf16=False):
    _, dims, hidden, folds, rows, c_dim, z_dim, _ = shape
    return roofline.fused_train_step(folds, rows, dims, c_dim, hidden, z_dim,
                                     bf16=bf16)


def check():
    t0 = time.perf_counter()
    lib_path = _build.build_library()
    _build.load_library()
    print(f"built {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    log = lib_path.with_suffix(".log").read_text().splitlines()
    for i, line in enumerate(log):
        if "Compiling entry function" in line and "mmnm_ts" in line:
            used = next((u for u in log[i + 1:i + 6] if "registers" in u), "")
            spill = next((u for u in log[i + 1:i + 6] if "spill" in u), "")
            name = line.split("'")[1]
            print(f"  ptxas {name[:60]}: {used.strip()} | {spill.strip()}")
    for key, shape in SHAPES.items():
        for route_name, route in ROUTES.items():
            if route_name == "wide 528":
                continue
            step, named, batch = problem(shape)
            step.route = route
            plan = ts.plan(step, batch[0].shape[0], batch[0].shape[2])
            losses, grads = step.loss_and_grads_padded(named, *batch)
            torch.cuda.synchronize()
            ref_l, ref_g = cs.plain64(step.reference, named, batch)
            for k in losses:
                cs.check_close(f"K5 {key} {route_name} {k}", losses[k],
                               ref_l[k], cs.STEP_LOSS_TOL)
            tol = (cs.STEP_GRAD_TOL_WIDE if max(shape[1]) > 1000
                   else cs.STEP_GRAD_TOL)
            err = max(cs.check_close(f"K5 {key} {route_name} d{k}", grads[k],
                                     ref_g[k], tol)[0] for k in grads)
            cs.check_bit_equal(f"K5 {key} {route_name}", grads,
                               step.loss_and_grads_padded(named, *batch)[1])
            print(f"K5 {key} route {route_name} {plan}: max abs err "
                  f"{err:.3e}, bit-equal", flush=True)
        for dtype in (torch.float32, torch.bfloat16):
            step, named, batch = problem(shape, TiledFusedTrainStep,
                                         tile_b=shape[4] // 3 or 1,
                                         compute_dtype=dtype)
            losses, grads = step.loss_and_grads_padded(named, *batch)
            torch.cuda.synchronize()
            b = batch
            if dtype == torch.bfloat16:
                b = (batch[0].bfloat16(), batch[1].bfloat16()) + batch[2:]
            ref_l, ref_g = cs.plain64(step.reference, step.cast_exec(named), b)
            leaf = max(cs.leaf_error(grads[k], ref_g[k]) for k in grads)
            cs.check_bit_equal(f"K6 {key} {dtype}", grads,
                               step.loss_and_grads_padded(named, *batch)[1])
            print(f"K6 {key} {dtype} tile {step.tile_b}: worst leaf "
                  f"{leaf:.3e} vs its plain version, bit-equal", flush=True)
            if not leaf < (cs.BF16_OWN if dtype == torch.bfloat16 else 1e-4):
                raise RuntimeError(f"K6 {key} {dtype}: leaf {leaf}")


def routes():
    for key in ("flagship", "PPMI"):
        shape = SHAPES[key]
        for what, cls, kw, bf16 in (
                ("K5", ts.FusedTrainStep, {}, False),
                ("K6 bf16 tile 64", TiledFusedTrainStep,
                 dict(tile_b=cs.TILE, compute_dtype=torch.bfloat16), True)):
            step, named, batch = problem(shape, cls, **kw)
            # the batch stored in the operand type, as the trainer keeps it
            stored = step.cast_batch({"x": batch[0], "c": batch[1]})
            batch = (stored["x"], stored["c"]) + batch[2:]
            work = work_of(shape, bf16)
            times = {}
            for _ in range(2):       # each route twice, in turns
                for route_name, route in ROUTES.items():
                    step.route = route
                    ms = cs.cuda_ms(
                        lambda: step.loss_and_grads_flat(named, *batch))
                    times.setdefault(route_name, []).append(round(ms, 4))
            step.route = 0
            plan = ts.plan(step, batch[0].shape[0], batch[0].shape[2])
            print(f"{what} {key}: bound {work.bound_ms:.5f} ms by "
                  f"{work.bound_by} ({work.peak_name}); auto plan {plan}; "
                  f"CUDA-event ms per step by route {json.dumps(times)}",
                  flush=True)


def profile_run(what, dims, rows_per_fold, epochs, seed, precision="fp32"):
    from torch.profiler import ProfilerActivity, profile

    wall = [cs.fused_training_run(dims, rows_per_fold, epochs, seed,
                                  fused=True, precision=precision)[2]
            for _ in range(2)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, traced_ms, steps = cs.fused_training_run(
            dims, rows_per_fold, epochs, seed, fused=True,
            precision=precision)
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    # copies and fills are the run's set-up (model init, batch upload) and
    # its closing fetch: the profiled window holds the whole run
    rows = [e for e in device if not e.key.startswith(("Memcpy", "Memset"))]
    copies = sum(e.count for e in device) - sum(e.count for e in rows)
    busy_us = sum(e.device_time_total for e in rows)
    count = sum(e.count for e in rows)
    top = sorted(rows, key=lambda e: -e.device_time_total)[:14]
    print(f"{what} ({precision}): {steps} steps; ms/step unprofiled "
          f"{wall[0]:.4f}, {wall[1]:.4f} (profiled {traced_ms:.4f}); device "
          f"kernels per step {count / steps:.1f} (and {copies} copies and "
          f"fills in the whole run); kernels busy "
          f"{busy_us / steps / 1e3:.4f} ms/step = "
          f"{100 * busy_us / 1e3 / steps / wall[1]:.1f}% of the second "
          "unprofiled run's step", flush=True)
    for e in top:
        print(f"    {e.device_time_total / steps / 1e3:.4f} ms/step  "
              f"x{e.count / steps:.1f}  {e.key[:90]}", flush=True)


def profile_steps():
    profile_run("flagship", cs.DIMS, cs.TRAIN_ROWS, cs.TRAIN_EPOCHS, seed=3)
    profile_run("PPMI width", cs.PPMI_DIMS, cs.PPMI_ROWS, 1, seed=4)
    profile_run("flagship", cs.DIMS, cs.TRAIN_ROWS, cs.TRAIN_EPOCHS, seed=3,
                precision="bf16")


def main():
    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA device is available",
              file=sys.stderr)
        return 2
    card()
    modes = {"check": check, "routes": routes, "profile": profile_steps}
    for mode in sys.argv[1:] or ["check"]:
        modes[mode]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
