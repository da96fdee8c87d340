"""Straggler detection: per-step wall-time EWMA with deviation triggers
(counterpart of ``repro.runtime.straggler``).

On a real pod a straggling host shows up as a slow step for EVERYONE (SPMD
collectives synchronize), so detection is local: track the step-time EWMA and
flag steps beyond ``threshold`` x the running mean. The trainer's response
policy, in order: log -> skip non-critical work (eval/checkpoint deferral) ->
after ``evict_after`` consecutive flags, report the host for eviction (which
triggers the elastic re-mesh path in fault.py).

Flag and evict events are routed through the flight recorder
(:mod:`repro_torch.obs.events`, kinds ``straggler_flag`` / ``straggler_evict``)
so they survive into crash dumps; ``events`` keeps a *bounded* local ring
(the newest ``max_events``) for direct inspection. For naming *which link*
is slow rather than which step, see
:class:`repro_torch.obs.health.LinkStragglerDetector`.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Optional

from repro_torch.obs import events as obs_events

#: retained flag events per detector — diagnosis ring, not a history
MAX_EVENTS = 256


@dataclasses.dataclass
class StragglerDetector:
    alpha: float = 0.1          # EWMA weight
    threshold: float = 2.5      # x mean -> flagged
    evict_after: int = 5        # consecutive flags -> evict recommendation
    warmup: int = 3             # ignore first steps (compile, cache warm)
    max_events: int = MAX_EVENTS

    _ewma: Optional[float] = None
    _seen: int = 0
    _consecutive: int = 0
    events: Deque[dict] = dataclasses.field(default=None)  # set post-init

    def __post_init__(self) -> None:
        if self.events is None:
            self.events = collections.deque(maxlen=int(self.max_events))

    def observe(self, step: int, dt: float) -> dict:
        """Feed one step duration; returns {flagged, evict, ewma}."""
        self._seen += 1
        if self._seen <= self.warmup:
            return {"flagged": False, "evict": False, "ewma": dt}
        if self._ewma is None:
            self._ewma = dt
        flagged = dt > self.threshold * self._ewma
        if flagged:
            self._consecutive += 1
            self.events.append({"step": step, "dt": dt, "ewma": self._ewma})
            obs_events.record(
                "straggler_flag", step=int(step), dt=round(dt, 6),
                ewma=round(self._ewma, 6),
            )
        else:
            self._consecutive = 0
            self._ewma = (1 - self.alpha) * self._ewma + self.alpha * dt
        evict = self._consecutive >= self.evict_after
        if evict and self._consecutive == self.evict_after:
            obs_events.record(
                "straggler_evict", step=int(step),
                consecutive=self._consecutive,
            )
        return {
            "flagged": flagged,
            "evict": evict,
            "ewma": self._ewma,
        }
