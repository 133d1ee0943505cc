"""l1_fdm_ms.heat: device time of the surrogate FDM per level-1 solve,
in ms: the device operations launched inside the ``l1_fdm`` span over
the traced ops, over the calls of the ``l1_solve`` span (profiler).
Nothing where the level-1 solver runs no surrogate."""


def read(t):
    tr = t.trace
    calls = tr.range_calls.get("l1_solve", 0) if tr else 0
    secs = tr.range_device_s.get("l1_fdm", 0.0) if tr else 0.0
    return 1e3 * secs / calls if calls and secs > 0 else None
