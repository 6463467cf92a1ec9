"""One intra-op thread for a port test module, restored after it.

The port's CPU tests run small tensors, where PyTorch's intra-op thread
pool buys no time; beside the other test workers on the same cores its
idle threads spin and cost CPU.  A test module takes the fixture by
importing it:

    from _torch_threads import one_intraop_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intraop_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
