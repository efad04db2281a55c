"""One torch thread a test, for the port's CPU tests.

The suite runs several pytest workers on the host's cores (`-n 6`), and at
smoke shapes a test gains nothing from intra-op threads: with torch's
default of one thread a core in every worker, the workers' thread pools
oversubscribe the cores and a test that takes 0.3 s alone took 80-111 s in
the suite.  A test file imports the fixture to apply it to its tests:

    from _threads import one_torch_thread  # noqa: F401  (autouse)
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch.set_num_threads(1) for the test, the previous count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
