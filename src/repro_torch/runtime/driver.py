"""The straggler watchdog of `repro.runtime.driver`.

Only `StragglerStats` is ported: the serve3d scheduler keeps one per
session.  A slice slower than ``ewma + sigma * dev`` is flagged, then the
EWMA of the wall time and of its deviation moves by ``alpha``.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class StragglerStats:
    ewma: float = 0.0
    dev: float = 0.0
    n_flagged: int = 0
    initialized: bool = False

    def update(self, dt: float, sigma: float, alpha: float) -> bool:
        if not self.initialized:
            self.ewma, self.dev, self.initialized = dt, dt * 0.1, True
            return False
        flagged = dt > self.ewma + sigma * max(self.dev, 1e-9)
        self.dev = (1 - alpha) * self.dev + alpha * abs(dt - self.ewma)
        self.ewma = (1 - alpha) * self.ewma + alpha * dt
        if flagged:
            self.n_flagged += 1
        return flagged
