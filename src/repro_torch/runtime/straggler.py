"""Straggler detection: robust step-time outlier flagging.

At 1000+ nodes, slow hosts show up as step-time outliers (every step is a
barrier). The monitor keeps a rolling window of step durations and flags
steps whose modified z-score (median/MAD — robust to the slow tail it is
trying to detect) exceeds a threshold. The launcher logs flags and, above
``abort_ratio``, recommends a checkpoint-restart excluding the slow host —
the standard mitigation when a VM is degraded rather than dead.

A copy of ``repro/runtime/straggler.py`` (the port imports nothing of the
reference package).
"""
from __future__ import annotations

import collections
import dataclasses
import statistics
import time
from typing import List, Optional

__all__ = ["StepTimeMonitor"]


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    zscore: float


class StepTimeMonitor:
    def __init__(self, window: int = 64, z_threshold: float = 4.0,
                 abort_ratio: float = 3.0, warmup: int = 8):
        self.window = collections.deque(maxlen=window)
        self.z_threshold = z_threshold
        self.abort_ratio = abort_ratio
        self.warmup = warmup
        self.events: List[StragglerEvent] = []
        self._t0: Optional[float] = None
        self._step = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> Optional[StragglerEvent]:
        if self._t0 is None:
            raise RuntimeError("stop() without start()")
        dur = time.perf_counter() - self._t0
        self._t0 = None
        return self.record(self._step, dur)

    def record(self, step: int, duration: float) -> Optional[StragglerEvent]:
        self._step = step + 1
        ev = None
        if len(self.window) >= self.warmup:
            med = statistics.median(self.window)
            mad = statistics.median(abs(d - med) for d in self.window) or 1e-9
            z = 0.6745 * (duration - med) / mad
            if z > self.z_threshold:
                ev = StragglerEvent(step, duration, z)
                self.events.append(ev)
        # slow samples are *not* added to the window (keep the baseline clean)
        if ev is None:
            self.window.append(duration)
        return ev

    def should_restart(self) -> bool:
        """True when recent steps are consistently >abort_ratio x median."""
        if len(self.window) < self.warmup or len(self.events) < 3:
            return False
        med = statistics.median(self.window)
        recent = self.events[-3:]
        return all(e.duration > self.abort_ratio * med for e in recent)

    def report(self) -> str:
        med = statistics.median(self.window) if self.window else float("nan")
        return (f"steps={self._step} median={med:.4f}s "
                f"stragglers={len(self.events)} restart={self.should_restart()}")
