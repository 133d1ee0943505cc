"""krylov_s.fresh: the refined solve (the program's Timers ``solve``,
synchronised), mean per op."""


def read(t):
    ops = [o["timers"] for o in t.ops if o.get("timers")]
    return sum(p.get("solve", 0.0) for p in ops) / len(ops) if ops \
        else None
