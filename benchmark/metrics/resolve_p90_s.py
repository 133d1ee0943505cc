"""resolve_p90_s: the 90th percentile over all the window's solves of a
solve's time, each taken between two CUDA events around it (the
device's clock: a solve lasts ~0.2 s, shorter than a host-clock reading
should span)."""

import statistics


def read(t):
    times = [o["device_s"] for o in t.ops]
    if len(times) < 2:
        return None
    return statistics.quantiles(times, n=10, method="inclusive")[8]
