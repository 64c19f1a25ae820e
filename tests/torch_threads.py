"""torch on one intra-op thread for the port's CPU tests.

The suite runs in 6 worker processes on 8 cores (`-n 6`).  torch's
default intra-op pool holds a thread per core in every worker, and the
port's tests run thousands of small ops, whose threads then spin against
each other's: ``flight_smoke`` took 59 s of CPU time for 21 s of wall
time on 8 threads, 21 s for 22 s on one; two calibrations took 790 s in a
6-worker run where they take 13 s alone.  A test module that imports
:func:`one_thread_module` runs its tests on one thread; a subprocess gets
``ONE_THREAD_ENV`` in its environment."""
import contextlib

import pytest
import torch

# what a subprocess of a test adds to its environment: one OpenMP thread
ONE_THREAD_ENV = {"OMP_NUM_THREADS": "1"}


@contextlib.contextmanager
def one_thread():
    """torch on one intra-op thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def one_thread_module():
    """Autouse in each module that imports it: the module's tests run
    under :func:`one_thread`."""
    with one_thread():
        yield
