"""Where does expert-parallel training part from the unmeshed packed run?

Run as two ranks of one torchrun (both on cuda:0 under gloo on one card):

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        scripts/torch_ep_probe.py [--device cuda] [--epochs 1 3 10]

On the ADHD cohort of chip_smoke.py phase 12b (2 x 116, SE-gPoE, -H 110 110
10, 10 folds) this compares, on rank 0: one step's loss and every gradient
leaf of ``parallel.modality.build_ep_step`` (modality axis 2) against the
unmeshed padded layout's (models/stacked.py) on the same draws, each leaf
bit for bit and by its largest difference; then ``EPFoldTrainer`` against
``PackedMultiFoldTrainer`` from the same weights and noise, and the
per-modality ``MultiFoldTrainer`` against it too, the parameters' largest
difference after each of ``--epochs``, with the worst element's movement
from its initial value in both runs. Prints one JSON object as its
last line (rank 0).
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))


def flat_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat_leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flat_leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def main():
    from multi_modal_normative_modeling_tpu_torch.cli import (
        common,
        train_supervised,
    )
    from multi_modal_normative_modeling_tpu_torch.interop import (
        packed_from_model,
        params_to_jax,
    )
    from multi_modal_normative_modeling_tpu_torch.ops.shard import (
        modality_shard,
        part,
    )
    from multi_modal_normative_modeling_tpu_torch.parallel import (
        distributed,
        stack_fold_batches,
    )
    from multi_modal_normative_modeling_tpu_torch.parallel.modality import (
        EPFoldTrainer,
        ModalityShard,
        build_ep_step,
        make_ep_mesh,
    )
    from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
    from multi_modal_normative_modeling_tpu_torch.train.packed import (
        PackedBatches,
        PackedMultiFoldTrainer,
        _leaves,
        _rebuild,
    )
    from torch_fold_stack_probe import prepare

    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--epochs", type=int, nargs="+", default=[1, 3, 10])
    opts = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_ep_mesh(2, 1, device=opts.device)
    device = mesh.device
    with tempfile.TemporaryDirectory() as tmp:
        # every rank makes the same cohort in its own directory
        args, folds, config_dict = prepare(Path(tmp))
    batches = stack_fold_batches([f[0] for f in folds], [f[1] for f in folds],
                                 256)
    max_n = max(f[0][0].shape[0] for f in folds)
    result = {}

    def model():
        m = common.build_model_from_config(config_dict, folds=len(folds))
        train_supervised.default_init(m, config_dict["model"])
        return m.to(device)

    # -- one step ------------------------------------------------------------
    config = TrainConfig(epochs=max(opts.epochs), batch_size=256,
                         learning_rate=0.0001, combine=args.combine, seed=42)
    trainer = PackedMultiFoldTrainer(model(), config, max_n)
    layout = trainer.layout
    packed = PackedBatches(batches, layout, device)
    batch = packed.step(0)
    eps = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (len(folds), 256, 10)).astype(np.float32)).to(device)
    tree = packed_from_model(trainer.model, layout)
    leaves = [t.detach().clone().requires_grad_(True) for t in _leaves(tree)]
    whole = _rebuild(tree, leaves)
    with torch.enable_grad():
        loss, _ = trainer._loss(whole, batch, eps)
        want = torch.autograd.grad(loss.sum(), leaves, allow_unused=True)
    shard = ModalityShard(mesh)
    with modality_shard(shard):
        local = _rebuild(tree, [part(t.detach(), t.shape[1]).clone()
                                .requires_grad_(True) for t in _leaves(tree)])
        x_local = part(batch["x"][0], 2).contiguous()
    got_loss, got = build_ep_step(layout, args.combine, mesh)(
        local, x_local, batch["c"], eps, batch["mask"])
    pieces = mesh.all_gather_object([g.detach().cpu().numpy()
                                     for g in _leaves(got)])
    names = [k for k, _ in flat_leaves(tree)]
    step = {}
    for i, name in enumerate(names):
        g = np.concatenate([p[i] for p in pieces], axis=1)
        w = (np.zeros_like(g) if want[i] is None
             else want[i].detach().cpu().numpy())
        d = np.abs(g - w)
        step[name] = {"bit_equal": bool((d == 0).all()),
                      "max_abs": float(d.max()),
                      "max_rel": float((d / (np.abs(w) + 1e-30)).max())}
    result["loss_diff"] = float((got_loss - loss.detach()).abs().max())
    result["step"] = step

    # -- trajectories ----------------------------------------------------------
    from multi_modal_normative_modeling_tpu_torch.parallel import (
        MultiFoldTrainer,
    )

    runs = {}
    for name, make in (
            ("packed", lambda: PackedMultiFoldTrainer(model(), config, max_n)),
            ("ep", lambda: EPFoldTrainer(model(), config, max_n, mesh)),
            ("per-modality", lambda: MultiFoldTrainer(model(), config,
                                                      max_n))):
        tr = make()
        init = params_to_jax(tr.model)
        runs[name] = (init, {m: params for m, params, _ in
                             tr.run_milestones(batches, opts.epochs)})
    traj = {}
    init = dict(flat_leaves(runs["packed"][0]))
    for epoch in opts.epochs:
        traj[epoch] = {"ep": worst_element(runs, "ep", epoch, init),
                       "per-modality": worst_element(runs, "per-modality",
                                                     epoch, init)}
    result["trajectory"] = traj
    if mesh.primary:
        differ = {k: v for k, v in step.items() if not v["bit_equal"]}
        print("step leaves that differ:", differ, flush=True)
        print(json.dumps(result))
    distributed.shutdown()


def worst_element(runs, other, epoch, init):
    """The largest parameter difference of run ``other`` from the packed
    run after ``epoch`` epochs, and where: the worst element's movement
    from its initial value in both runs."""
    worst = (0.0, None)
    for f in range(len(runs["packed"][1][epoch])):
        a = dict(flat_leaves(runs["packed"][1][epoch][f]))
        b = dict(flat_leaves(runs[other][1][epoch][f]))
        for k in a:
            d = np.abs(np.asarray(a[k]) - np.asarray(b[k]))
            if d.max() > worst[0]:
                i = np.unravel_index(d.argmax(), d.shape)
                start = np.asarray(init[k])[f][i]
                worst = (float(d.max()), {
                    "fold": f, "leaf": k, "index": [int(j) for j in i],
                    "packed_moved": float(np.asarray(a[k])[i] - start),
                    "other_moved": float(np.asarray(b[k])[i] - start)})
    return {"max_abs": worst[0], "worst": worst[1]}


if __name__ == "__main__":
    main()
