"""A module-scoped fixture that keeps PyTorch's intra-op thread pool small
while a port test module runs, and its own test.

The test suite runs in several worker processes at once. PyTorch's default
pool takes one thread per core in EACH of them, and the oversubscribed
OpenMP threads then spend their time spinning: the port's CPU tests (tiny
tensors, thousands of small ops) ran 30 times slower with six processes at
the default than with two threads each. A port test module opts in with

    from test_torch_threads import few_torch_threads  # noqa: F401
"""

import pytest
import torch

THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(THREADS, before))
    yield
    torch.set_num_threads(before)


def test_pool_is_small_here_and_results_do_not_depend_on_it():
    here = torch.get_num_threads()
    assert here <= THREADS
    x = torch.arange(12.0).reshape(3, 4)
    want = (x @ x.T).sum().item()
    torch.set_num_threads(1)
    try:
        assert (x @ x.T).sum().item() == want
    finally:
        torch.set_num_threads(here)
