"""Does a fold's training trajectory depend on how many folds are stacked?

On an ADHD cohort (2 x 116, SE-gPoE, -H 110 110 10, 10 folds; chip_smoke.py
phase 12b's cohort) this trains every fold at once, and folds 0-4 alone,
from the same initial weights with the same per-fold noise
(``MultiFoldTrainer``, fp32, TF32 off), and compares the shared folds'
parameters after 10 and after 200 epochs against the JAX fold-axis bound
(rtol 2e-4 / atol 2e-5). Then it feeds the same per-fold operands to each
fold-stacked product of one training step (``ops/linear.apply_linear``'s
``x @ w.mT`` and the two products of its backward, and the loss's row and
feature sums) at F=5 and at F=10, and reports which differ bit for bit,
with their shapes; and the gradient of every parameter after one step of
the plain loss on the cohort's first batch, F=5 against F=10, naming the
leaves whose folds 0-4 differ.

    python3 scripts/torch_fold_stack_probe.py [--epochs 10 200] [--device cuda]

Prints one JSON object as its last line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

TOL = dict(rtol=2e-4, atol=2e-5)
FLAGS = ["-R", "ADHD", "-P", "SE-gPoE", "-K", "10", "-H", "110", "110",
         "10", "-E", "1"]
COHORT = dict(n_hc=300, n_disease={0: 150, 2: 150})


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def prepare(root: Path):
    from multi_modal_normative_modeling_tpu_torch import registry
    from multi_modal_normative_modeling_tpu_torch.cli import (
        common,
        train_supervised,
    )
    from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
        make_synthetic_resource,
    )

    make_synthetic_resource(root, "ADHD", **COHORT)
    args = train_supervised.build_parser().parse_args(FLAGS)
    common.apply_post_parse_defaults(args)
    kfold_dir = root / "outputs" / "kfold_analysis"
    model_dir = kfold_dir / "supervised_cvae"
    model_dir.mkdir(parents=True, exist_ok=True)
    import pandas as pd

    ids = pd.read_csv(root / "data" / "ADHD" / "y.csv")
    hc = registry.get_hc_label("ADHD")
    np.random.seed(42)
    common.generate_kfold_ids(ids[ids["DIA"] == hc], ids[ids["DIA"] != hc],
                              oversample_percentage=args.oversample_percentage,
                              n_splits=args.n_splits, project_root=root)
    names = registry.get_datasets_name(args.dataset_resourse, args.procedure)
    folds, dims, c_dim = common.prepare_folds(
        args, root, kfold_dir, model_dir, names,
        root / "data" / "ADHD" / "y.csv")
    return args, folds, common.model_config_dict(args, dims, c_dim,
                                                 len(names))


def train(args, folds, config_dict, milestones, device):
    """{epoch: [per-fold params (JAX layout)]} of every fold in ``folds``
    trained at once."""
    from multi_modal_normative_modeling_tpu_torch.cli import (
        common,
        train_supervised,
    )
    from multi_modal_normative_modeling_tpu_torch.parallel import (
        MultiFoldTrainer,
        stack_fold_batches,
    )
    from multi_modal_normative_modeling_tpu_torch.train import TrainConfig

    config = TrainConfig(epochs=max(milestones), batch_size=256,
                         learning_rate=0.0001, combine=args.combine,
                         seed=42)
    model = common.build_model_from_config(config_dict, folds=len(folds))
    train_supervised.default_init(model, config_dict["model"])
    model.to(device)
    max_n = max(f[0][0].shape[0] for f in folds)
    batches = stack_fold_batches([f[0] for f in folds], [f[1] for f in folds],
                                 256)
    trainer = MultiFoldTrainer(model, config, max_n)
    return {m: params for m, params, _ in
            trainer.run_milestones(batches, milestones)}


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [np.asarray(tree, np.float64)]


def distance(a, b):
    """(max abs diff, max over leaves of |a-b| - rtol |b| - atol (<= 0
    inside the bound)) over every leaf of two param trees."""
    worst, excess = 0.0, -np.inf
    for x, y in zip(leaves(a), leaves(b)):
        d = np.abs(x - y)
        worst = max(worst, float(d.max()))
        excess = max(excess, float((d - TOL["atol"]
                                    - TOL["rtol"] * np.abs(y)).max()))
    return worst, excess


def product_probe(device):
    """Each fold-stacked product of a training step at F=5 and F=10 on the
    same per-fold operands: {name: {shape, bit_equal, max_abs}}."""
    gen = torch.Generator().manual_seed(0)
    out = {}
    shapes = {
        "enc layer 0 (x|c @ w.mT)": (256, 116 + 29, 110),
        "enc layer 1": (256, 110, 110),
        "enc heads": (256, 110, 10),
        "dec layer 0 (z|c)": (256, 10 + 29, 110),
        "dec mean head": (256, 110, 116),
    }
    for name, (b, k, n) in shapes.items():
        x = torch.randn((10, b, k), generator=gen).to(device)
        w = torch.randn((10, n, k), generator=gen).to(device)
        g = torch.randn((10, b, n), generator=gen).to(device)
        ops = {
            "forward x @ w.mT": lambda x, w, g: x @ w.mT,
            "grad_x g @ w": lambda x, w, g: g @ w,
            "grad_w g.mT @ x": lambda x, w, g: g.mT @ x,
            "row sum": lambda x, w, g: torch.sum(g, dim=1),
            "feature sum": lambda x, w, g: torch.sum(x, dim=2),
        }
        for op, fn in ops.items():
            ten = fn(x, w, g)[:5]
            five = fn(x[:5].contiguous(), w[:5].contiguous(),
                      g[:5].contiguous())
            out[f"{name}: {op}"] = {
                "shape": [list(x.shape[1:]), list(w.shape[1:])],
                "bit_equal": bool(torch.equal(ten, five)),
                "max_abs": float((ten - five).abs().max())}
    return out


def gradient_probe(args, folds, config_dict, device):
    """{parameter: max abs difference of folds 0-4's gradients} of one step
    of the plain loss at F=10 against F=5 (0.0: bit-equal)."""
    from multi_modal_normative_modeling_tpu_torch.cli import (
        common,
        train_supervised,
    )
    from multi_modal_normative_modeling_tpu_torch.parallel import (
        stack_fold_batches,
    )
    from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
    from multi_modal_normative_modeling_tpu_torch.train.trainer import (
        DeviceBatches,
        resolve_loss,
    )

    config = TrainConfig(epochs=1, batch_size=256, combine=args.combine)
    grads = {}
    for n in (10, 5):
        model = common.build_model_from_config(config_dict, folds=n)
        train_supervised.default_init(model, config_dict["model"])
        model.to(device)
        batches = DeviceBatches(stack_fold_batches(
            [f[0] for f in folds[:n]], [f[1] for f in folds[:n]], 256),
            device)
        eps = torch.randn((10, 256, model.noise_dim),
                          generator=torch.Generator().manual_seed(3))
        loss_fn, _ = resolve_loss(model, config, None)
        total, _ = loss_fn(batches.step(0), eps[:n].to(device))
        names = [k for k, _ in model.named_parameters()]
        grads[n] = dict(zip(names, torch.autograd.grad(
            total.sum(), list(model.parameters()))))
    return {k: float((grads[10][k][:5] - grads[5][k]).abs().max())
            for k in grads[5]}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, nargs="+", default=[10, 200])
    parser.add_argument("--device", default="cuda")
    opts = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {"card": card() if opts.device == "cuda" else "cpu"}
    with tempfile.TemporaryDirectory() as tmp:
        args, folds, config_dict = prepare(Path(tmp))
    grads = gradient_probe(args, folds, config_dict, opts.device)
    result["gradients_differ"] = {k: v for k, v in grads.items() if v}
    print("gradients that differ at F=5 against F=10:",
          result["gradients_differ"], flush=True)
    ten = train(args, folds, config_dict, opts.epochs, opts.device)
    five = train(args, folds[:5], config_dict, opts.epochs, opts.device)
    result["trajectory"] = {}
    for epoch in opts.epochs:
        per_fold = [distance(ten[epoch][f], five[epoch][f]) for f in range(5)]
        result["trajectory"][epoch] = {
            "max_abs": max(d for d, _ in per_fold),
            "within_bound": bool(max(e for _, e in per_fold) <= 0),
            "bit_equal": all(d == 0.0 for d, _ in per_fold)}
    result["products"] = product_probe(opts.device)
    differing = [k for k, v in result["products"].items()
                 if not v["bit_equal"]]
    print("products that differ at F=5 against F=10:", differing, flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
