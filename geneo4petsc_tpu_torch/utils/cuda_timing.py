"""Timing of device work with CUDA events, two candidates in turns.

Two cards of one name, or one card at two moments, differ by a few per
cent, so two versions are compared only inside one process, in turns
(a, b, b, a), and a median over several rounds is reported with the
spread of the rounds beside it.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch


def time_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean time of one call in ms over ``reps`` back-to-back calls."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def time_in_turns(a: Callable[[], object], b: Callable[[], object],
                  reps: int = 20, rounds: int = 5, warmup: int = 3
                  ) -> tuple[dict, dict]:
    """Time ``a`` and ``b`` in turns (a, b, b, a) for ``rounds`` rounds.

    Returns for each a dict with the median (``ms``), the least and the
    most (``min_ms``, ``max_ms``) of its 2 * rounds readings, each
    reading the mean of ``reps`` calls."""
    for _ in range(warmup):
        a()
        b()
    torch.cuda.synchronize()
    ta, tb = [], []
    for _ in range(rounds):
        ta.append(time_ms(a, reps))
        tb.append(time_ms(b, reps))
        tb.append(time_ms(b, reps))
        ta.append(time_ms(a, reps))

    def summary(ts):
        return {"ms": statistics.median(ts), "min_ms": min(ts),
                "max_ms": max(ts)}

    return summary(ta), summary(tb)
