"""The port's tests whose tensors are tiny import ``one_thread``: torch's
intra-op thread pool only adds waits there, and many of them when the
machine is loaded (the tier-1 run's six workers share its cores). The
module runs on one thread and gives the count back after its last
test."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
