"""Thread caps, a time limit and clean-up for the port's tests: a plugin that
each tests/test_torch_*.py file loads with ``pytest_plugins = ["torch_limits"]``.
It acts on the tests of the files that load it, and not on their
``chip``-marked ones (those build kernels on the card, for minutes); the JAX
package's tests run as they did. This module and tests/procs.py go by their
bare names (pytest puts tests/ on ``sys.path``): on the card's machine an
installed package named ``tests`` shadows this directory, and
tests/test_torch_spans.py runs there.

* Threads: torch runs 2 intra-op threads and BLAS (numpy, scipy) 1, in the
  test and, through ``OMP_NUM_THREADS`` and ``OPENBLAS_NUM_THREADS``, in
  every process it starts, where the environment does not set them already.
  Six xdist workers at torch's default of a thread a core spun ~48 threads
  on 8 cores, and the port's tests took ~3x as long.
* Time: SIGALRM fails a test whose set-up and call run past ``TIME_LIMIT``,
  or whose teardown runs past ``TEARDOWN_LIMIT``, with every thread's stack
  (faulthandler) in its stderr; the next test runs. The handler runs only
  once the main thread is back in Python: a hang inside a C call (a gloo
  collective, a blocking read) is not cut.
* Processes: what the test started through tests/procs.py is killed, with
  all it started, when the test ends.
"""

import contextlib
import faulthandler
import os
import signal
import time

import pytest
import torch

import procs

# s for set-up and call: ~3x the slowest port test in the suite,
# test_torch_learning.py::test_training_learns_constant_images (52-79 s).
TIME_LIMIT = 300
TEARDOWN_LIMIT = 60
THREADS = {"OMP_NUM_THREADS": "2", "OPENBLAS_NUM_THREADS": "1"}
_DEADLINE = pytest.StashKey[float]()


def _ours(item):
    return (__name__ in getattr(getattr(item, "module", None), "pytest_plugins", ())
            and item.get_closest_marker("chip") is None)


def _blas_threads(n):
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # numpy's BLAS keeps its threads; the children are capped all the same
        return contextlib.nullcontext()
    return threadpool_limits(n, "blas")


def _expire(signum, frame):
    faulthandler.dump_traceback(all_threads=True)
    raise TimeoutError("the test ran past its time limit; every thread's stack is in its stderr")


@contextlib.contextmanager
def _alarm(seconds):
    previous = signal.signal(signal.SIGALRM, _expire)
    signal.setitimer(signal.ITIMER_REAL, max(seconds, 1e-3))
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item):
    if not _ours(item):
        return (yield)
    threads = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as env:
        for name, value in THREADS.items():
            env.setenv(name, os.environ.get(name, value))
        torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
        try:
            with _blas_threads(int(os.environ["OPENBLAS_NUM_THREADS"])):
                return (yield)
        finally:
            torch.set_num_threads(threads)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    if not _ours(item):
        return (yield)
    item.stash[_DEADLINE] = time.monotonic() + TIME_LIMIT
    with _alarm(TIME_LIMIT):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    if not _ours(item):
        return (yield)
    with _alarm(item.stash[_DEADLINE] - time.monotonic()):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    if not _ours(item):
        return (yield)
    try:
        with _alarm(TEARDOWN_LIMIT):
            return (yield)
    finally:
        procs.reap()
