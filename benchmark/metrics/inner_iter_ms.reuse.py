"""inner_iter_ms.reuse: the window's solve time over its inner
iterations, in ms (host clock over the program's counts)."""


def read(t):
    its = sum(o["inner"] for o in t.ops)
    return 1e3 * sum(o["wall_s"] for o in t.ops) / its if its else None
