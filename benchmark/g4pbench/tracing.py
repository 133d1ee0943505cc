"""Spans of the benchmark's own files, and the reduction of a
``torch.profiler`` trace to the numbers the per-layer readers take.

A traced run profiles its traced ops twice.  The first pass records
the device alone (``profiler(device, host=False)``), which costs the
host little: it gives the busy time, the window and the device
operations by name.  The second records the host's ops too, which
slows the host several-fold: it gives each span's device time and what
the host ran before each idle gap.

A span is a ``record_function`` range named ``bench.<name>``.  A device
operation belongs to a span when the host op that launched it (linked
by the profiler's correlation id) started inside the span.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch
from torch.autograd import DeviceType

PREFIX = "bench."
NAME_CHARS = 160        # kernel names are cut to this length in the record


@contextmanager
def span(name: str):
    with torch.profiler.record_function(PREFIX + name):
        yield


def profiler(device: torch.device, host: bool = True):
    """A profiler of the device's operations, and of the host's ops
    and spans where ``host``."""
    acts = []
    if host or device.type != "cuda":
        acts.append(torch.profiler.ProfilerActivity.CPU)
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False, profile_memory=False)


@dataclass
class TraceSummary:
    window_s: float                   # the traced window
    busy_s: float                     # union of device operations in it
    range_calls: dict = field(default_factory=dict)      # span -> calls
    range_device_s: dict = field(default_factory=dict)   # span -> seconds
    device_ops: list = field(default_factory=list)       # [name, seconds]
    idle_gaps: list = field(default_factory=list)        # [host op, seconds]
    n_device_ops: int = 0


def _times(e) -> tuple[int, int]:
    """(start, end) in ns, across profiler versions."""
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.end_ns()
    s = int(e.start_us() * 1000)
    return s, s + int(e.duration_us() * 1000)


class _Spans:
    """The intervals of one span name, for point lookups."""

    def __init__(self, intervals):
        self.iv = sorted(intervals)
        self.starts = [s for s, _ in self.iv]

    def containing(self, t: int):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.iv[i][1] >= t:
            return self.iv[i]
        return None


def reduce(prof, window: str = "window") -> TraceSummary:
    """The trace of ``prof`` over its span ``window`` or, in a trace of
    the device alone, from its first device operation to its last."""
    ops = {}                        # correlation id -> (start ns, name)
    spans = defaultdict(list)
    dev = []                        # (start, end, name, linked id)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if e.linked_correlation_id() != 0 or name.startswith("["):
                continue            # runtime calls, memory records
            s, t = _times(e)
            if name.startswith(PREFIX):
                spans[name[len(PREFIX):]].append((s, t))
            else:
                ops[e.correlation_id()] = (s, name)
        elif not name.startswith(PREFIX):   # a span's device-side copy
            s, t = _times(e)
            dev.append((s, t, name, e.linked_correlation_id()))
    if window in spans:
        (w0, w1), = spans.pop(window)
    elif dev:
        w0, w1 = min(d[0] for d in dev), max(d[1] for d in dev)
    else:
        w0 = w1 = 0
    lookups = {k: _Spans(v) for k, v in spans.items()}
    dev = sorted(d for d in dev if d[1] > w0 and d[0] < w1)

    by_name = defaultdict(float)
    range_s = defaultdict(float)
    merged = []                     # [start, end, first op's launch]
    for s, t, name, corr in dev:
        s, t = max(s, w0), min(t, w1)
        by_name[name] += (t - s) / 1e9
        launch = ops.get(corr)
        if launch is not None:
            for k, look in lookups.items():
                if look.containing(launch[0]) is not None:
                    range_s[k] += (t - s) / 1e9
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t, launch])
    busy = sum(t - s for s, t, _ in merged) / 1e9

    gaps = defaultdict(float)
    prev = w0
    for s, t, launch in merged:
        if s > prev:
            gaps[_label(launch, lookups)] += (s - prev) / 1e9
        prev = t
    if w1 > prev:
        gaps["after the last device op"] += (w1 - prev) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(
        window_s=(w1 - w0) / 1e9, busy_s=busy,
        range_calls={k: len(v) for k, v in spans.items()},
        range_device_s=dict(range_s),
        device_ops=[[n[:NAME_CHARS], v] for n, v in top],
        idle_gaps=[[n, v] for n, v in
                   sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
        n_device_ops=len(dev))


def _label(launch, lookups) -> str:
    """What the host ran to end an idle gap: the innermost span and the
    host op that launched the next device operation."""
    if launch is None:
        return "unlinked device op"
    t, name = launch
    inner, inner_start = None, None
    for k, look in lookups.items():
        iv = look.containing(t)
        if iv is not None and (inner_start is None or iv[0] > inner_start):
            inner, inner_start = k, iv[0]
    return f"{inner}/{name}" if inner else name
