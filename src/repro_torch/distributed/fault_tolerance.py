"""Step-time health monitoring and straggler detection — the port's copy of
``repro/distributed/fault_tolerance.py``.

A step whose time exceeds ``straggler_factor`` x the EWMA is flagged
(logged and counted). The trainer's run loop survives worker exceptions by
restoring the latest checkpoint (``train/trainer.py``). On the card the
trainer's :class:`StepTimer` wraps the step and the loss's readback to the
host, so it times a synchronised step, not its enqueue.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional


@dataclasses.dataclass
class HealthMonitor:
    ewma_alpha: float = 0.1
    straggler_factor: float = 2.5
    warmup_steps: int = 5

    _ewma: Optional[float] = None
    _steps: int = 0
    straggler_events: int = 0
    history: List[float] = dataclasses.field(default_factory=list)

    def record_step(self, seconds: float) -> bool:
        """Record one step's wall time; True if this step was a straggler."""
        self._steps += 1
        self.history.append(seconds)
        is_straggler = False
        if self._ewma is None:
            self._ewma = seconds
        else:
            if (self._steps > self.warmup_steps
                    and seconds > self.straggler_factor * self._ewma):
                self.straggler_events += 1
                is_straggler = True
                # Outliers stay out of the EWMA, so the baseline stays honest.
            else:
                self._ewma = (self.ewma_alpha * seconds
                              + (1 - self.ewma_alpha) * self._ewma)
        return is_straggler

    @property
    def baseline_s(self) -> Optional[float]:
        return self._ewma


class StepTimer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        return False
