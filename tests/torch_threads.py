"""One intra-op thread for the port's CPU tests.

The port's tests run torch at tiny shapes, where one thread is as fast as
one a core. Under pytest-xdist several workers share the cores, and torch's
default of one thread a core oversubscribes them: a CLI test that takes 1 s
alone took 20 s beside eight busy processes, and 1 s with one thread.

Each test file of the port imports the fixture, which holds for its module:

    from torch_threads import one_torch_thread  # noqa: F401  (autouse)
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
