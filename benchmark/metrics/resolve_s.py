"""resolve_s: the window's time over its ops, each one refined solve
with the preconditioner kept — from the window's start to the end of
its last op, right-hand sides included (host clock)."""


def read(t):
    return t.window_s / len(t.ops) if t.ops else None
