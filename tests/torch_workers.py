"""The cores of one machine shared among pytest-xdist's workers, and a time
limit for tests that run loader threads in-process.

Each worker process would otherwise start as many torch intra-op threads as
the machine has cores, so that six workers on eight cores run some forty
threads of small CPU ops against each other.  Importing this module (the
port's tests import it through tests/test_torch_layers.py, which every worker
imports while it collects) gives each worker's torch its share of the cores.
Outside xdist it changes nothing.
"""
import contextlib
import os
import signal

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORKERS))


@contextlib.contextmanager
def time_limit(seconds):
    """Raise TimeoutError in the test's (main) thread once `seconds` have
    passed, so that a hung loader thread fails its test instead of holding
    the worker until the whole run is cut."""
    def expire(*_):
        raise TimeoutError(f"the test ran past its {seconds} s limit")
    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)
