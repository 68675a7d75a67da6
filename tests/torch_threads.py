"""A fixture for the port's CPU tests of small tensors: one intra-op thread.

The tier-1 run puts six test processes on the machine's cores at once. A
PyTorch op on tiny tensors split over every core then waits at its barrier
for threads the other processes hold, which made such tests 10-40 times
slower there than alone. One thread a process gives the same results
(each comparison in these tests is between values computed under the same
setting, or held to a tolerance) without the waits.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
