"""One torch thread for each port test module (``tests/test_torch_*.py``
import this fixture).

The suite runs as six pytest-xdist workers on a machine of eight cores,
and torch gives each worker a thread a core by default: the workers'
many small ops then wait on each other's threads.  With one thread each,
the heaviest port files took a third of the time (ROADMAP.md, "The
suite's time")."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
