"""setup_s: seconds from the process's start to the window's start —
imports, the field, the preconditioner's set-up (resolve ops) and the
warm-up ops (host clock)."""


def read(t):
    return t.setup_s
