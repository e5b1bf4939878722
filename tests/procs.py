"""The processes the port's tests start. Each runs in a session of its own,
its output in temporary files. Every session is killed, with all that is left
in it, when the test ends (tests/torch_limits.py calls :func:`reap`) and when
the worker is sent SIGTERM, as ``timeout`` sends it to a whole run."""

import contextlib
import os
import signal
import subprocess
import tempfile

import pytest

_live = []  # every process started and not yet reaped
_previous = None  # SIGTERM's handler before this module's


def start(cmd, stderr=subprocess.STDOUT, **kw):
    """``cmd`` in a session of its own; its errors go with its output unless
    ``stderr=subprocess.PIPE`` keeps them apart."""
    global _previous
    if signal.getsignal(signal.SIGTERM) is not _terminated:
        _previous = signal.signal(signal.SIGTERM, _terminated)
    apart = stderr == subprocess.PIPE
    out = tempfile.TemporaryFile("w+")
    err = tempfile.TemporaryFile("w+") if apart else stderr
    p = subprocess.Popen(cmd, stdout=out, stderr=err, start_new_session=True, **kw)
    p.files = (out, err if apart else None)
    _live.append(p)
    return p


def wait_all(procs):
    """Each process's (output, errors) once all have ended; errors is None
    where they went with the output. Where the test's time limit cuts the
    wait, fails the test with all they printed so far (its end kills them)."""
    try:
        for p in procs:
            p.wait()
    except TimeoutError:
        pytest.fail("the test's time limit cut the wait:\n" + "\n".join(
            f"--- {p.args}:\n{out}{err or ''}" for p, (out, err) in zip(procs, map(_read, procs))))
    return [_read(p) for p in procs]


def reap():
    """Kills every session started and not yet reaped, with all left in it."""
    while _live:
        p = _live.pop()
        _kill(p)
        p.wait()


def _kill(p):
    with contextlib.suppress(ProcessLookupError):
        os.killpg(p.pid, signal.SIGKILL)


def _read(p):
    return tuple(map(_text, p.files))


def _text(f):
    if f is None:
        return None
    f.seek(0)
    return f.read()


def _terminated(signum, frame):
    for p in _live:  # no wait: the one this signal cut holds its process's lock
        _kill(p)
    signal.signal(signum, _previous or signal.SIG_DFL)
    os.kill(os.getpid(), signum)
