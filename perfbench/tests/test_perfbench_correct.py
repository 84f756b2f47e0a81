"""What decides ``correct``, at small shapes on the CPU (the port's plain
versions stand where its kernels run on the card):

  * the reference against the program: a sound run is correct;
  * the control, the reference in TF32 put in the program's place, fails
    a number of every cell;
  * a run with the timed path broken underneath comes out not correct,
    once for each fault the cell can have: a training step that leaves
    the state as it was, half of every batch left out (the mean over the
    rest). (Every cell runs on one chip: there is no exchange between
    chips to leave out.)
"""
import pytest
import torch

from perfbench import harness, spec
from perfbench.reference.cvae import Reference

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def run(small, cell, seed=11):
    return harness.run_cell(cell, seed, 0.2, False, "cpu", **small(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(small, cell):
    result = run(small, cell)
    assert result["correct"] is True, result["checks"]
    assert list(result)[-1] == "checks"
    for check in result["checks"].values():
        assert check["value"] < check["limit"] / 10


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(small, cell):
    parts = small(cell)
    cell = spec.generator(parts["mix"])(parts["cfg"], parts["mix"], 11, "cpu")
    harness.run_window(cell, 0.2)
    numbers = cell.check(cell.take_outputs(), tuple(parts["limits"]),
                           stand_in=Reference(parts["cfg"], tf32=True))
    assert any(numbers[k] > limit for k, limit in parts["limits"].items()), \
        numbers


def _half_batch_step(monkeypatch):
    from multi_modal_normative_modeling_tpu_torch.kernels.train_step import (
        FusedTrainStep,
    )

    real = FusedTrainStep.loss_and_grads_flat

    def half(self, named, x, c, eps, rm, nvalid):
        rm = rm.clone()
        rm[:, rm.shape[1] // 2:] = 0.0
        return real(self, named, x, c, eps, rm,
                    torch.clamp(rm.sum(-1), min=1.0))

    monkeypatch.setattr(FusedTrainStep, "loss_and_grads_flat", half)


def _unchanged_state(monkeypatch):
    from multi_modal_normative_modeling_tpu_torch.train.trainer import (
        MaskedAdam,
    )

    monkeypatch.setattr(MaskedAdam, "step_flat", lambda self, g, valid: None)


@pytest.mark.parametrize("cell, fault", [
    (c, f) for c in CELLS for f in (_unchanged_state, _half_batch_step)])
def test_a_broken_path_is_not_correct(small, monkeypatch, cell, fault):
    fault(monkeypatch)
    result = run(small, cell)
    assert result["correct"] is False, result["checks"]
