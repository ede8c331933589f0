"""An autouse fixture for the port's CPU tests: torch on one intra-op thread.

The suite runs several pytest workers on the machine's cores.  With torch's
default intra-op pool (a thread a core) in every worker, each of the many
small ops of the reduced models waits on a pool that the other workers'
threads crowd out: a file of them ran five times slower than on one
thread.  A test file takes the fixture by importing it::

    from torch_threads import one_torch_thread  # noqa: F401 (autouse)
"""

import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
