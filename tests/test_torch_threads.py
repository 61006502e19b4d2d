"""One torch thread for the port's CPU tests.

The tier-1 run spreads the test files over six worker processes on the
machine's cores. torch's default intra-op pool takes a thread per core in
each process, and small torch ops then spin against each other: one test
took 0.3 s alone and 50 s beside five busy processes, and the port's test
files took 723 s under six workers, 192 s with one thread each. Every port
test module imports `one_torch_thread`, an autouse fixture that holds torch
at one thread for the module and restores the count after it.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_a_port_module_runs_on_one_torch_thread():
    assert torch.get_num_threads() == 1
