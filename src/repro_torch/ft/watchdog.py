"""Straggler accounting (``StepWatchdog`` of ``repro/ft/watchdog.py``).

On a real multi-pod deployment the per-host agent exports step latencies
and the controller reschedules persistent stragglers.  This module is
that controller's logic, host-local and fully testable:

  * ``StepWatchdog`` tracks a rolling latency window; a step slower than
    ``threshold ×`` the rolling median is flagged; ``k`` consecutive
    flags escalate to a straggler verdict (callback → in production, a
    reschedule request; in the data path, a ``backup_of`` hedge on the
    slow host's shard).  The serving batcher uses it for per-batch
    latency.
"""
from __future__ import annotations

import collections
import statistics
import time
from typing import Callable, Deque, Optional


class StepWatchdog:
    def __init__(self, threshold: float = 3.0, window: int = 32,
                 escalate_after: int = 3,
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        self.threshold = threshold
        self.window: Deque[float] = collections.deque(maxlen=window)
        self.escalate_after = escalate_after
        self.on_straggler = on_straggler
        self.consecutive_slow = 0
        self.flagged_steps = []
        self.escalations = []
        self._t0: Optional[float] = None

    def start_step(self) -> None:
        self._t0 = time.perf_counter()

    def end_step(self, step: int,
                 duration: Optional[float] = None) -> bool:
        """Records a step; returns True if flagged slow."""
        if duration is None:
            if self._t0 is None:
                raise RuntimeError("end_step without start_step/duration")
            duration = time.perf_counter() - self._t0
            self._t0 = None
        slow = False
        if len(self.window) >= 8:
            med = statistics.median(self.window)
            slow = duration > self.threshold * med
        self.window.append(duration)
        if slow:
            self.flagged_steps.append(step)
            self.consecutive_slow += 1
            if self.consecutive_slow >= self.escalate_after:
                self.escalations.append(step)
                self.consecutive_slow = 0
                if self.on_straggler:
                    self.on_straggler(step, duration)
        else:
            self.consecutive_slow = 0
        return slow

