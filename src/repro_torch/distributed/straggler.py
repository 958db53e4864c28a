"""Straggler detection (host-side control plane).

In SPMD data parallelism a straggler host delays every collective; the
cure at fleet scale is detect -> flag -> replace + deterministic resume
(the data pipeline is cursor-addressed, so a replacement host rejoins
mid-epoch without skew).  This monitor implements the detect/flag part:
an EWMA watermark over per-step wall times with an outlier multiplier.
The port's own copy of the JAX package's module (pure Python).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional


@dataclasses.dataclass
class StragglerMonitor:
    ewma_alpha: float = 0.1
    trigger_ratio: float = 2.0     # step > ratio * ewma -> flag
    warmup_steps: int = 5
    _ewma: Optional[float] = None
    _steps: int = 0
    flagged: int = 0

    def record(self, step_seconds: float) -> bool:
        """Record one step; returns True if this step looks straggled."""
        self._steps += 1
        if self._ewma is None:
            self._ewma = step_seconds
            return False
        slow = (self._steps > self.warmup_steps
                and step_seconds > self.trigger_ratio * self._ewma)
        if slow:
            self.flagged += 1
        else:
            # stragglers don't poison the watermark
            self._ewma = (1 - self.ewma_alpha) * self._ewma \
                + self.ewma_alpha * step_seconds
        return slow

    @property
    def watermark(self) -> float:
        return self._ewma or 0.0


class StepTimer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.seconds = time.perf_counter() - self.t0
