"""One torch thread per test, for the port's CPU test files.

The tier-1 run spreads the test files over several worker processes
side by side (pytest-xdist); a torch thread pool in each process
oversubscribes the cores, which slows a pool's spinning threads by
orders of magnitude.  A test file takes the fixture by importing it::

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the test on one torch thread, and restore the count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
