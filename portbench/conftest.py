"""The benchmark's CPU tests run beside the rest of the suite on a shared
host: each keeps torch to one thread, so that it takes one core."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread for the test, restored after it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
