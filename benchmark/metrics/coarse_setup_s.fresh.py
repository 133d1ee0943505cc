"""coarse_setup_s.fresh: the coarse basis Z and the coarse matrix E with
its factor (the program's Timers ``l2_z`` + ``l2_e``), mean per op."""


def read(t):
    ops = [o["timers"] for o in t.ops if o.get("timers")]
    if not ops:
        return None
    return sum(p.get("l2_z", 0.0) + p.get("l2_e", 0.0)
               for p in ops) / len(ops)
