"""Torch on one thread for a test module of the port, imported by each
tests/test_torch_*.py module that runs the plain versions:

    from torch_threads import one_torch_thread  # noqa: F401 (autouse)

The plain versions run hundreds of small ops a bounce, and under the
suite's parallel workers, which share the cores, each worker's OpenMP
threads spin against the others': a plain compacted render at 40 px that
takes 2.9 s alone (1.3 s on one thread) took 98 s beside the other
workers, slowing every file on the machine with it."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
