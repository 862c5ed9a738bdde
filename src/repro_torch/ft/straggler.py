"""Straggler mitigation bookkeeping; a copy of ``repro.ft.straggler``
(stdlib only).

On a real pod the step is a global barrier; one slow host drags everyone.
Policy implemented here (and exercised in tests with simulated timings):

  * EMA + deviation tracking of per-step wall time;
  * a step slower than ``deadline_factor`` x EMA flags a straggler event;
  * after ``evict_after`` consecutive flags the driver is told to drop to
    the rescue path: checkpoint and restart without the slow host, the
    standard large-fleet play.

The monitor is host-side and engine-agnostic: the graph engine and the LM
trainer both feed it.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class StragglerMonitor:
    deadline_factor: float = 3.0
    evict_after: int = 3
    ema_decay: float = 0.9
    ema: float | None = None
    consecutive: int = 0
    events: int = 0

    def observe(self, step_time: float) -> dict:
        """Feed one step time; returns {straggler, evict, deadline}."""
        if self.ema is None:
            self.ema = step_time
            return {"straggler": False, "evict": False,
                    "deadline": step_time * self.deadline_factor}
        deadline = self.ema * self.deadline_factor
        straggler = step_time > deadline
        if straggler:
            self.consecutive += 1
            self.events += 1
        else:
            self.consecutive = 0
            # only healthy steps update the EMA (a straggler step should not
            # inflate the baseline and mask the next one)
            self.ema = self.ema_decay * self.ema + \
                (1 - self.ema_decay) * step_time
        return {"straggler": straggler,
                "evict": self.consecutive >= self.evict_after,
                "deadline": deadline}
