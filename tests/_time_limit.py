"""A time limit for each test, on SIGALRM (no plugin package needed).

Each phase of a test (setup, call, teardown) runs under an alarm of
``DEFAULT_S`` seconds, or of ``n`` for a test marked
``@pytest.mark.timeout_s(n)`` (the nearest mark wins: a test's own over
its module's ``pytestmark``).  A phase that outlives its limit fails with
the test's ID and the limit in the message, and the worker goes on to the
next test.  The alarm interrupts Python code, and a blocking wait such as
``subprocess.run`` or ``queue.get``; a long call into C (a compile, a
factorisation) is interrupted when it returns.

Tests marked ``slow`` (minutes each, outside tier-1) run without a limit
unless they carry one.  ``LIMITS`` holds the limits of tests whose files
carry no ``timeout_s`` mark.  A wait inside a test takes its timeout from
``wait_s``, so that it fails before the phase's alarm.

tests/test_threads.py loads this plugin for the whole session
(``pytest_plugins``); the ``timeout_s`` marker is registered in
``pyproject.toml``.  Another pytest run loads it with ``-p _time_limit``
(``tests/`` on ``PYTHONPATH``).
"""

import signal
import threading

import pytest

DEFAULT_S = 240

# the JAX package's test of an f32 E on the 32^3 grid, 64 boxes: 365 s
# alone on 8 cores, 562 s in tier-1 beside five other xdist workers
LIMITS = {
    "tests/test_structured_geneo.py::test_f32_e_assembly_no_false_pruning":
        1200,
}


def limit_s(node) -> float | None:
    """The limit of a test, or of the module or class that holds it."""
    mark = node.get_closest_marker("timeout_s")
    if mark:
        return float(mark.args[0])
    if node.nodeid in LIMITS:
        return float(LIMITS[node.nodeid])
    return None if node.get_closest_marker("slow") else float(DEFAULT_S)


def wait_s(node, waits: int = 1, margin_s: float = 30.0) -> float:
    """The timeout of each of ``waits`` blocking waits (a rank launch, a
    subprocess) in one phase of ``node``: an equal share of its limit
    less ``margin_s``."""
    return (limit_s(node) - margin_s) / waits


def _limited(item, phase):
    limit = limit_s(item)
    if limit is None or not hasattr(signal, "SIGALRM") or \
            threading.current_thread() is not threading.main_thread():
        return (yield)

    def expired(_signum, _frame):
        pytest.fail(f"{item.nodeid} ran past its time limit of {limit:g} s "
                    f"(in {phase})", pytrace=False)

    previous = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, limit)
    try:
        return (yield)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    return (yield from _limited(item, "setup"))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    return (yield from _limited(item, "call"))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    return (yield from _limited(item, "teardown"))
