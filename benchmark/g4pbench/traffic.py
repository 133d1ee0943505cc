"""The one general traffic generator: it reads a mix's parameters
(``traffic/<mix>.json``) and gives each op its right-hand side.  One
caller runs the ops in a closed loop, back to back, after one warm-up
op in set-up.

Parameters:

* ``op`` — the op kind, which with the configuration's ``system``
  names the system file ``systems/<system>.<op>.py``: ``solve`` (one
  whole library solve of the configuration's manufactured system) or
  ``resolve`` (the preconditioner kept, one refined solve of a given b);
* ``rhs`` — ``manufactured`` (x = 1..n, the reference generator's
  oracle) or ``normal`` (x_s standard normal in float64, drawn anew for
  each solve from the seed and the solve's index); a system that solves
  a given b gets b = A x from the reference operator;
* ``collect_garbage`` — the caller collects garbage after each op, as
  a process that ends with its job would free everything;
* ``trace_ops`` — ops traced after the window in a ``--trace 1`` run
  with the device alone recorded (one more follows with the host's ops
  recorded too);
* ``check_share`` — the share of the window's ops, drawn from the seed,
  whose answers the reference checks (the last op always is).
"""

from __future__ import annotations

import numpy as np
import torch

# independent streams drawn from one seed
RHS, CHECKS = 0, 1


def stream_seed(seed: int, stream: int, index: int) -> int:
    """A 63-bit generator seed for item ``index`` of stream ``stream``
    of the run's seed."""
    st = np.random.SeedSequence([int(seed) % 2**64, stream, index])
    return int(st.generate_state(1, np.uint64)[0] >> np.uint64(1))


class Traffic:
    def __init__(self, params: dict, seed: int, n: int,
                 device: torch.device):
        self.p = params
        self.seed, self.n, self.device = int(seed), int(n), device
        if params["rhs"] not in ("manufactured", "normal"):
            raise ValueError(f"unknown rhs {params['rhs']!r}")
        self._pick = np.random.default_rng(stream_seed(self.seed, CHECKS, 0))

    @property
    def collect_garbage(self) -> bool:
        return bool(self.p.get("collect_garbage", False))

    @property
    def trace_ops(self) -> int:
        return int(self.p.get("trace_ops", 1))

    def x_true(self, index: int) -> torch.Tensor:
        """The exact solution of solve ``index`` (of the window, or of
        the warm-up or the traced ops), float64."""
        if self.p["rhs"] == "manufactured":
            return torch.arange(1, self.n + 1, dtype=torch.float64,
                                device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(
            stream_seed(self.seed, RHS, index))
        return torch.randn(self.n, generator=gen, dtype=torch.float64,
                           device=self.device)

    def checked(self) -> bool:
        """Whether the next window op's answer is kept for the check."""
        return bool(self._pick.random() < float(self.p["check_share"]))
