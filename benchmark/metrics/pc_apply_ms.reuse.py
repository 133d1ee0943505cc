"""pc_apply_ms.reuse: device time per preconditioner apply, in ms: the
device operations launched inside the ``pc_apply`` span over the traced
ops, over its calls (profiler)."""


def read(t):
    tr = t.trace
    calls = tr.range_calls.get("pc_apply", 0) if tr else 0
    secs = tr.range_device_s.get("pc_apply", 0.0) if tr else 0.0
    return 1e3 * secs / calls if calls and secs > 0 else None
