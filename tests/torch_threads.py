"""The port's CPU tests share the host's cores between pytest-xdist's
workers: each ``tests/test_torch_*.py`` imports :func:`torch_thread_cap`,
which gives torch ``os.cpu_count() // PYTEST_XDIST_WORKER_COUNT`` intra-op
threads (at least 1; all the cores without xdist) while the file's tests
run, and restores the old count after them.

Left at torch's default (one thread a core) in every worker, the workers'
threads outnumber the cores and spin against each other: a forward that
takes 0.23 s alone took 195-198 s with six such workers on eight cores,
and 0.55-1.30 s with one thread each. The thread count is process-wide
state, the one the port's tests set; it changes no value a test
compares."""
import os

import pytest
import torch


def thread_cap() -> int:
    """The threads a worker gets: its share of the host's cores."""
    workers = int(os.environ.get('PYTEST_XDIST_WORKER_COUNT') or 1)
    return max(1, (os.cpu_count() or 1) // max(1, workers))


@pytest.fixture(scope='module', autouse=True)
def torch_thread_cap():
    old = torch.get_num_threads()
    torch.set_num_threads(thread_cap())
    try:
        yield
    finally:
        torch.set_num_threads(old)
