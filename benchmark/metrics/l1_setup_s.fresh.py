"""l1_setup_s.fresh: the level-1 factor's set-up (the program's Timers
``l1_minv``, synchronised), mean per op."""


def read(t):
    ops = [o["timers"] for o in t.ops if o.get("timers")]
    return sum(p.get("l1_minv", 0.0) for p in ops) / len(ops) if ops \
        else None
