"""host_prep_s.fresh: the library entry's decomposition and right-hand
side (the program's Timers ``partition`` + ``createA``), mean per
op."""


def read(t):
    ops = [o["timers"] for o in t.ops if o.get("timers")]
    if not ops:
        return None
    return sum(p.get("partition", 0.0) + p.get("createA", 0.0)
               for p in ops) / len(ops)
