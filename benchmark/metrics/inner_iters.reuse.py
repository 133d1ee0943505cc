"""inner_iters.reuse: float32 inner Krylov iterations per solve over the
window (the program's ``RefinedResult.inner_its``)."""


def read(t):
    return sum(o["inner"] for o in t.ops) / len(t.ops) if t.ops else None
