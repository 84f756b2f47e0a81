"""Whole k-fold training jobs back to back on the fused train step.

A job is what the train CLI's ``--fused_train_step`` path runs for one
experiment: ``FusedFoldTrainer.batches`` packs and uploads every fold's
rows, ``FusedFoldTrainer.run`` trains every fold for the configuration's
epochs (one K5 step and one MaskedAdam update a batch) and returns the
trained parameters and the per-epoch logs. The benchmark makes each job's
initial parameters (on the card), rows (on the card, then on the host, as
the CLI hands them over) and every noise draw (on the card, replayed), for
``pool`` distinct jobs that the window cycles through.

Mix parameters: ``pool`` (distinct jobs), ``check_steps`` (steps compared
with the reference, rounded up to whole jobs: the reference follows each
checked job from its first step to its last), ``loss_epochs`` (logged
epochs compared), ``warm_epochs`` (epochs of the warm-up's one session:
every shape of a job), ``trace_units`` (steps in the traced sub-window,
rounded up to whole jobs).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from .. import compare, inputs, work
from ..reference.cvae import Reference


class Generator:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from multi_modal_normative_modeling_tpu_torch.models import build_model
        from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
        from multi_modal_normative_modeling_tpu_torch.train.fused import (
            FusedFoldTrainer,
        )

        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        folds, n = cfg["folds"], cfg["subjects_per_fold"]
        batch, epochs = cfg["batch_size"], cfg["epochs"]
        dims, c_dim = cfg["input_dim_list"], cfg["c_dim"]
        self.steps_per_job = epochs * -(-n // batch)
        self.samples_per_job = folds * n * epochs
        self.jobs = []
        for p in range(mix["pool"]):
            gen = inputs.generator(seed, "train_job", p, self.device)
            tree = inputs.init_tree(cfg, folds, gen)
            rows = inputs.normal(gen, (folds, n, sum(dims)))
            cov = inputs.one_hot_covariates(gen, (folds, n), c_dim)
            eps = inputs.normal(gen, (self.steps_per_job, folds, batch,
                                      cfg["latent_dim"]))
            host_x = [np.ascontiguousarray(a) for a in np.split(
                rows.cpu().numpy(), np.cumsum(dims)[:-1], axis=2)]
            host_c = cov.cpu().numpy()
            self.jobs.append({
                "tree": tree, "eps": eps, "host_x": host_x, "host_c": host_c,
                "data": [[x[f] for x in host_x] for f in range(folds)],
                "cov": [host_c[f] for f in range(folds)]})
            del rows, cov
        model = build_model(cfg["model"], dims, cfg["hidden_dim"],
                            cfg["latent_dim"], c_dim, len(dims), folds=folds,
                            device=self.device)
        config = TrainConfig(epochs=epochs, batch_size=batch,
                             learning_rate=cfg["learning_rate"],
                             combine=cfg["combine"], precision="fp32")
        self.trainer = FusedFoldTrainer(model, config, n)
        for job in self.jobs:
            job["packed"] = self.trainer.stacked.pack_params(job["tree"])
        self.holding = False
        self.held: Dict[int, tuple] = {}

    # ---- the yardstick of one unit (a step) ---------------------------------
    def unit_work(self) -> work.Work:
        return work.train_step(self.cfg)

    def unit_model_flops(self) -> float:
        return work.train_step_model_flops(self.cfg)

    def units_of(self, items: int) -> int:
        """Steps in ``items`` jobs."""
        return items * self.steps_per_job

    def samples_of(self, items: int) -> int:
        """Fold-samples trained in ``items`` jobs (each fold's rows, each
        epoch)."""
        return items * self.samples_per_job

    # ---- the warm-up and the timed call -------------------------------------
    def warm(self) -> None:
        """Every shape of a job: its rows packed and uploaded, then
        ``warm_epochs`` epochs of a session on pool entry 0, which is left
        as it was."""
        job = self.jobs[0]
        batches = self.trainer.batches(job["data"], job["cov"], self.device)
        session = self.trainer.session(job["packed"], batches, job["eps"])
        session.advance(self.mix["warm_epochs"])
        self.trainer.trained(session)

    def item(self, k: int) -> None:
        """Job number ``k`` of the run, on pool entry k mod pool."""
        p = k % len(self.jobs)
        job = self.jobs[p]
        with record_function("perfbench.batches"):
            batches = self.trainer.batches(job["data"], job["cov"],
                                           self.device)
        with record_function("perfbench.run"):
            trained, logs = self.trainer.run(job["packed"], batches,
                                             eps=job["eps"])
        if self.holding:
            self.held[p] = (trained, logs)

    # ---- the comparison -----------------------------------------------------
    def checked(self) -> List[int]:
        """The pool entries compared: drawn from the seed among those a
        job of the window trained."""
        done = sorted(self.held)
        rng = np.random.default_rng([self.seed % 2**32, 2])
        want = -(-self.mix["check_steps"] // self.steps_per_job)
        take = min(want, len(done))
        return sorted(rng.choice(done, size=take, replace=False).tolist())

    def take_outputs(self) -> dict:
        """The checked jobs' outputs on the host; everything of the program
        is then let go."""
        out = {p: (compare.packed_to_tree(self.held[p][0], self.cfg),
                   self.held[p][1]) for p in self.checked()}
        self.held.clear()
        self.trainer = None
        for job in self.jobs:
            job.pop("packed", None)
        return out

    def check(self, outputs: dict,
              numbers=("loss_gap", "ll_gap", "change_gap"),
              stand_in: Reference = None, detail: bool = False
              ) -> Dict[str, float]:
        """The ``numbers`` of the checked jobs (their worst); the reference
        follows each whole job. ``stand_in`` takes the program's place (the
        control, a fault); ``detail`` adds each logged term's gap by
        epoch."""
        cfg = self.cfg
        ref = Reference(cfg)
        readings = []
        for p in sorted(outputs):
            job = self.jobs[p]
            xs = [torch.from_numpy(x).to(self.device) for x in job["host_x"]]
            c = torch.from_numpy(job["host_c"]).to(self.device)
            args = (job["tree"], xs, c, job["eps"], cfg["epochs"],
                    cfg["batch_size"], cfg["learning_rate"])
            ref_tree, ref_logs, first_grad = ref.train_job(*args)
            if stand_in is None:
                prog_tree, prog_logs = outputs[p]
            else:
                prog_tree, prog_logs = stand_in.train_job(*args)[:2]
            found = compare.train_loss_numbers(prog_logs, ref_logs,
                                               self.mix["loss_epochs"])
            found["change_gap"] = compare.change_gap(
                job["tree"], prog_tree, ref_tree, first_grad)
            if detail:
                found["quiet_leaves"] = len(compare.quiet_leaves(first_grad))
                found.update(compare.loss_gaps(
                    prog_logs, ref_logs, ref_logs["total"].shape[1]))
            readings.append(found)
        return compare.worst(readings)
