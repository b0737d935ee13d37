"""Serving-side failure vocabulary (port of the serving part of
`repro/runtime/fault.py`): the transient `DeviceFailure` the batcher's
retry policy absorbs, and the `StragglerDetector` watchdog over step times.

Not ported yet: `TrainLoop`, `FaultInjector` and `NanLossError`, which
belong to training and checkpointing (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List


class DeviceFailure(RuntimeError):
    """Stand-in for the runtime error a dead peer raises on real hardware."""


@dataclasses.dataclass
class StragglerDetector:
    """Online mean/variance of step times; a step slower than
    mean + z*std (and an absolute floor) is flagged."""

    z_threshold: float = 3.0
    min_steps: int = 8
    abs_floor_s: float = 0.05
    _n: int = 0
    _mean: float = 0.0
    _m2: float = 0.0
    flagged: List[int] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = False
        if self._n >= self.min_steps:
            std = math.sqrt(self._m2 / max(self._n - 1, 1))
            if dt > self._mean + self.z_threshold * std and dt > self._mean + self.abs_floor_s:
                is_straggler = True
                self.flagged.append(step)
        # Welford update (skip flagged steps so one outlier doesn't poison stats)
        if not is_straggler:
            self._n += 1
            d = dt - self._mean
            self._mean += d / self._n
            self._m2 += d * (dt - self._mean)
        return is_straggler
