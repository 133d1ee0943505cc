"""time_to_solution_s: the window's time over its ops, each one whole
solve — from the window's start to the end of its last op (host
clock)."""


def read(t):
    return t.window_s / len(t.ops) if t.ops else None
