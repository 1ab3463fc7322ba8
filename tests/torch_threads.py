"""One PyTorch intra-op thread for the port's CPU tests.

The suite runs in several pytest-xdist workers on one host, and PyTorch
starts one intra-op thread per core in each of them: the port's tests would
then crowd the host and slow the wall-clock tests of the JAX package that
run beside them.  Each ``tests/test_torch_*.py`` imports ``one_torch_thread``,
a module-scoped autouse fixture, so its tests run on one intra-op thread
and the count is restored after the module.
"""

import pytest


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    try:
        import torch
    except ImportError:
        yield
        return
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
