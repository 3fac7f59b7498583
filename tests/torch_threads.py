"""An autouse fixture for CPU test modules that train small models: one
intra-op thread for each test, the caller's count restored after it.

The suite runs six workers on the host's cores, each with torch's default
of one intra-op thread per core. A loop of small operations on eight
threads then waits on the other workers' threads at every parallel
region: ``tests/test_torch_quality_gate.py``'s
``test_main_writes_the_record_and_reuse_trains_no_reference`` took 91.5 s
with the cores kept busy, 6.1 s on one thread (2.2 s alone on idle
cores). A reduction split over fewer threads may sum in another order,
so a float32 result may differ at the level of its rounding: within
every tolerance the tests that use this fixture hold.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
