"""One intra-op torch thread for a test file: the suite runs files in
parallel workers, and a thread pool per worker oversubscribes the cores.
Import ``one_thread`` into a test module; it is an autouse fixture."""
from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
