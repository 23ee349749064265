"""A fixture for the port's CPU tests: ``from tests.torch_threads import
one_torch_thread`` in a test module runs its tests on one torch thread.

The suite runs several pytest workers on one machine's cores, and
torch's default of a thread a core then oversubscribes them: every
small op waits on a barrier of threads that have no core (six workers
ran a file about 20x slower than one). A module-scoped fixture sets one
thread for the module and restores the count after it, so the modules
that follow on the same worker are unaffected."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
