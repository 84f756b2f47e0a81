"""The seed, and only the seed, decides a run's inputs."""
import pytest
import torch

from perfbench import inputs

from conftest import SMALL


def draw(seed, what="train_job", index=0):
    gen = inputs.generator(seed, what, index, "cpu")
    tree = inputs.init_tree(SMALL, 2, gen)
    rows = inputs.normal(gen, (2, 7, 5))
    cov = inputs.one_hot_covariates(gen, (2, 7), SMALL["c_dim"])
    return [t for _, t in inputs.tree_leaves(tree)] + [rows, cov]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3])
def test_same_seed_same_inputs(seed):
    for a, b in zip(draw(seed), draw(seed)):
        assert torch.equal(a, b)


def test_other_seed_or_role_other_inputs():
    base = draw(2**31 + 11)
    for other in (draw(2**31 + 12), draw(2**31 + 11, "other_role"),
                  draw(2**31 + 11, index=1), draw(2**31 + 11 + 2**32)):
        assert not torch.equal(base[0], other[0])


def test_init_tree_shapes_and_ranges():
    gen = inputs.generator(3, "x", 0, "cpu")
    tree = inputs.init_tree(SMALL, 2, gen)
    enc0 = tree["enc"][3]["hidden"][0]
    assert enc0["w"].shape == (2, 27 + 5, 11)
    assert enc0["w"].abs().max() <= 1 / (27 + 5) ** 0.5
    assert tree["dec"][3]["mean"]["w"].shape == (2, 11, 27)
    assert torch.equal(tree["dec"][0]["logvar_out"],
                       torch.full((2, 1, 9), -3.0))
    assert tree["alpha"].shape == (2, 4)


def test_covariates_are_one_hot_age_and_sex():
    gen = inputs.generator(3, "c", 0, "cpu")
    c = inputs.one_hot_covariates(gen, (4, 50), 29)
    assert torch.equal(c[..., :27].sum(-1), torch.ones(4, 50))
    assert torch.equal(c[..., 27:].sum(-1), torch.ones(4, 50))
