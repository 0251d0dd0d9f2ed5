"""One computation a test session, shared by every pytest-xdist worker.

The spawning parity files (``tests/test_torch_tp.py``,
``tests/test_torch_tp_moe.py``, ``tests/test_torch_tp_hybrid.py``) hold
their cases against one costly module fixture: the ranks spawned and the
reference driven.  Under xdist every worker that runs one of a file's
cases would set that fixture up again.  :func:`once_a_session` makes the
first worker that needs it compute it under an exclusive lock on a file in
the session's shared temporary directory (every worker's basetemp is a
child of it) and pickle the result there; every other worker waits on the
lock and loads the result.  Without xdist it computes directly.
"""

from __future__ import annotations

import fcntl
import os
import pickle
import time
import traceback

import pytest

#: seconds a worker waits for another worker's result before it fails
WAIT_S = 1200


def once_a_session(request, tmp_path_factory, name: str, compute, wait_s: float = WAIT_S):
    """``compute()``, computed once a session: by this process without
    xdist; under xdist by the first worker to ask, under the lock
    ``<shared>/<name>.lock``, its result (or the error it raised) pickled to
    ``<shared>/<name>.pkl`` for the others, which wait up to ``wait_s``."""
    if not hasattr(request.config, "workerinput"):
        return compute()
    shared = tmp_path_factory.getbasetemp().parent
    data = shared / f"{name}.pkl"
    with open(shared / f"{name}.lock", "a+") as lock:
        deadline = time.monotonic() + wait_s
        while True:
            try:
                fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                if time.monotonic() > deadline:
                    pytest.fail(f"waited {wait_s} s for another worker to write {data}")
                time.sleep(0.5)
        try:
            if data.exists():
                with open(data, "rb") as f:
                    ok, value = pickle.load(f)
                if not ok:
                    pytest.fail(f"{data}: the worker that computed it failed:\n{value}")
                return value
            try:
                value = compute()
            except BaseException:
                _write(data, (False, traceback.format_exc()[-6000:]))
                raise
            _write(data, (True, value))
            return value
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _write(path, record) -> None:
    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(record, f)
    os.replace(tmp, path)
