"""One torch thread in the port's CPU tests.

The test run spreads the files over several worker processes on a few
cores. torch's intra-op pool spins at every parallel region's barrier, so
a worker that runs many small ops on all the cores while the others are
busy waits for threads that are not scheduled: the tiny hubs' CLI tests
ran 10-20x slower beside the other workers than alone. One thread a
worker keeps the cores for the workers. Import the fixture into a test
module (``from tests._port_threads import one_torch_thread``) and it holds
for that module's tests; the count is restored after them.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
