"""l2_eig_s.fresh: the GenEO eigensolves (the program's Timers
``l2_eig``, synchronised), mean per op."""


def read(t):
    ops = [o["timers"] for o in t.ops if o.get("timers")]
    return sum(p.get("l2_eig", 0.0) for p in ops) / len(ops) if ops \
        else None
