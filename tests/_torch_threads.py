"""Shared fixture for the port's CPU tests: torch on one intra-op thread.

The suite runs several pytest-xdist workers at once, each beside XLA's
own thread pool; torch's default of one OpenMP thread per core then
oversubscribes the CPU many times over and its small ops crawl. The
port's tests run small shapes, where one thread loses nothing. Import
the fixture into a test module to apply it there.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
