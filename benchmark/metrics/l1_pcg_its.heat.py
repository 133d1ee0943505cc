"""l1_pcg_its.heat: PCG iterations per level-1 apply over the window:
the change of the program's ``pcg_iterations`` counter over that of
``pcg_solves`` (only level-1 solves run PCG in the window)."""


def read(t):
    solves = t.counters.get("pcg_solves", 0)
    its = t.counters.get("pcg_iterations", 0)
    return its / solves if solves else None
