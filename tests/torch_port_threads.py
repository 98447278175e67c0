"""One intra-op torch thread while a port test module runs.

The suite runs its files in parallel worker processes (pytest-xdist,
``--dist loadfile``).  torch's default pool, one thread a core in every
worker, oversubscribes the cores that the workers and the JAX side's XLA
threads share.  Each ``tests/test_torch_port_*.py`` imports
``one_torch_thread``: an autouse fixture that holds torch at one
intra-op thread while the module's tests run and restores the count
after, so the count does not depend on which files a worker collected.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
