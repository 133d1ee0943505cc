"""The per-test time limit (tests/_time_limit.py), held in a pytest run of
its own: a test that sleeps past its ``timeout_s(1)`` fails with its ID
and its limit in the message, and the run goes on to the next test."""

import os
import time

import pytest

pytest_plugins = ["pytester"]

HERE = os.path.dirname(os.path.abspath(__file__))

SLEEPY = """
import time

import pytest


@pytest.fixture
def slow_fixture():
    time.sleep(30)


@pytest.mark.timeout_s(1)
def test_sleeps_in_call():
    time.sleep(30)


@pytest.mark.timeout_s(1)
def test_sleeps_in_setup(slow_fixture):
    pass


def test_next():
    pass
"""


@pytest.mark.parametrize("phase", ["call", "setup"])
def test_a_test_past_its_limit_fails_and_the_run_goes_on(pytester,
                                                         monkeypatch, phase):
    monkeypatch.setenv("PYTHONPATH", HERE)
    pytester.makepyfile(test_sleepy=SLEEPY)
    t0 = time.monotonic()
    res = pytester.runpytest_subprocess(
        "-p", "_time_limit", "-p", "no:cacheprovider", "-k",
        f"test_sleeps_in_{phase} or test_next", timeout=60)
    assert time.monotonic() - t0 < 25
    res.stdout.fnmatch_lines([
        f"*test_sleepy.py::test_sleeps_in_{phase} ran past its time limit "
        f"of 1 s (in {phase})*"])
    if phase == "call":
        res.assert_outcomes(failed=1, passed=1)
    else:
        res.assert_outcomes(errors=1, passed=1)
