"""Phase timers (TIME: line protocol parity).

The reference hand-rolls two-tier chrono timers (SURVEY.md §5.1): driver
phase timers (read/partition/createA/setup/iterations) plus per-phase PC
timers reduced with max over ranks.  One process hosts all domains here,
so the per-rank max reduction is the identity.  Callers synchronize the
device before reading the clock around device work.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Timers:
    phases: dict = field(default_factory=dict)

    def add(self, name: str, seconds: float) -> None:
        self.phases[name] = self.phases.get(name, 0.0) + seconds

    def get(self, name: str) -> float:
        return self.phases.get(name, 0.0)
