"""The device's idle share over the traced ops: 100 (1 - the union of
device operations / the traced window), from the profiler's trace."""


def read(t):
    tr = t.trace
    if tr is None or tr.busy_s <= 0 or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
