"""One torch thread in each test worker.

The suite runs in several pytest-xdist workers that share the machine's
cores. torch's intra-op pool starts one thread a core in every worker, and
on cores the other workers keep busy those threads mostly wait on each other:
a test of a few dozen small training steps then takes tens of times as long
as on one thread. The port's test files that compute with torch import
``one_torch_thread`` (an autouse fixture), which runs their module on one
thread and restores the worker's count after it.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_a_module_runs_on_one_torch_thread():
    assert torch.get_num_threads() == 1
