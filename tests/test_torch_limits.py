"""What tests/torch_limits.py and tests/procs.py give the port's tests: the
caps on torch's and BLAS's threads, in the test and in what it starts; a time
limit that fails a test which runs past it, with its stack, and lets the next
one run with its patches undone; and the sessions a test started killed, with
what they started, when its limit cuts a wait and when its worker is
terminated."""

import os
import re
import signal
import sys
import time

import procs

pytest_plugins = ["pytester", "torch_limits"]

TESTS = os.path.dirname(os.path.abspath(__file__))
CAPS = ("import numpy, threadpoolctl, torch\n"
        "caps = [torch.get_num_threads(), *{i['num_threads'] for i in "
        "threadpoolctl.threadpool_info() if i['internal_api'] == 'openblas'}]\n")
# A child that starts a grandchild, prints its pid and hangs.
HANGS = ("import subprocess, sys, time\n"
         "print(subprocess.Popen(['sleep', '60']).pid, flush=True)\n"
         "time.sleep(60)\n")


def _gone(pid):
    """Whether ``pid`` ends within 5 s (a zombie no one has reaped yet counts)."""
    for _ in range(50):
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().split(") ")[-1].startswith("Z"):
                    return True
        except FileNotFoundError:
            return True
        time.sleep(0.1)
    return False


def test_a_port_test_and_the_processes_it_starts_run_on_the_thread_caps():
    """torch's OpenMP threads and numpy's BLAS threads, here and in a child."""
    want = [int(os.environ["OMP_NUM_THREADS"]), int(os.environ["OPENBLAS_NUM_THREADS"])]
    here = {}
    exec(CAPS, here)
    p = procs.start([sys.executable, "-c", CAPS + "print(*caps)"])
    ((out, _),) = procs.wait_all([p])
    assert p.returncode == 0 and here["caps"] == want == list(map(int, out.split())), out


def test_a_test_past_its_time_limit_fails_with_its_stack_and_the_next_runs(pytester,
                                                                            monkeypatch):
    """A sleep and a wait on a hanging group cut at a 1 s limit: each fails
    with its stack or its group's output, the group is killed with its
    grandchildren, and the next test sees the cut one's patch undone."""
    pytester.makepyfile(test_inner=f"""
        import json
        import sys
        import time

        import procs
        import torch_limits

        pytest_plugins = ["torch_limits"]
        torch_limits.TIME_LIMIT = 1


        def test_sleeps_past_its_limit(monkeypatch):
            monkeypatch.setattr(json, "dumps", None)
            time.sleep(60)


        def test_runs_after_it():
            assert json.dumps([1]) == "[1]"


        def test_waits_on_a_group_past_its_limit():
            procs.wait_all([procs.start([sys.executable, "-c", {HANGS!r}]) for _ in range(2)])
    """)
    monkeypatch.setenv("PYTHONPATH", TESTS)
    began = time.monotonic()
    result = pytester.runpytest_subprocess("-p", "no:cacheprovider", timeout=120)
    assert time.monotonic() - began < 50  # cut at 1 s, not slept out
    result.assert_outcomes(passed=1, failed=2)
    result.stdout.fnmatch_lines([
        "*TimeoutError: the test ran past its time limit*",
        "*Captured stderr call*",
        "*File*test_inner.py*, line * in test_sleeps_past_its_limit*",
        "*Failed: the test's time limit cut the wait:*",
    ])
    result.stdout.fnmatch_lines(["*FAILED test_inner.py::test_sleeps_past_its_limit*",
                                 "*FAILED test_inner.py::test_waits_on_a_group_past_its_limit*"])
    grandchildren = list(map(int, re.findall(r"^E +(\d+)$", result.stdout.str(), re.M)))
    assert len(grandchildren) == 2, result.stdout.str()
    assert all(map(_gone, grandchildren)), grandchildren


def test_a_terminated_worker_kills_the_sessions_its_tests_started(pytester):
    """SIGTERM to a pytest process, as ``timeout`` sends it, while its test
    waits on a child: the child's grandchild goes too."""
    pids = pytester.path / "pids"
    hangs = HANGS.replace("flush=True", f"file=open({str(pids)!r}, 'w')")  # closed at once
    pytester.makepyfile(test_inner=f"""
        import sys

        import procs

        pytest_plugins = ["torch_limits"]


        def test_hangs():
            procs.wait_all([procs.start([sys.executable, "-c", {hangs!r}])])
    """)
    inner = procs.start([sys.executable, "-m", "pytest", "-p", "no:cacheprovider", "test_inner.py"],
                        cwd=pytester.path, env=dict(os.environ, PYTHONPATH=TESTS))
    for _ in range(600):
        if pids.exists() and pids.read_text().strip():
            break
        assert inner.poll() is None, procs.wait_all([inner])
        time.sleep(0.1)
    grandchild = int(pids.read_text())
    inner.send_signal(signal.SIGTERM)
    ((out, _),) = procs.wait_all([inner])
    assert inner.returncode == -signal.SIGTERM, out
    assert _gone(grandchild), (grandchild, out)
