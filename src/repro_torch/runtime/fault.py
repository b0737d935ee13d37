"""Fault tolerance (port of `repro/runtime/fault.py`): checkpoint /
restart, failure recovery, straggler detection.

Serving uses the transient `DeviceFailure` the batcher's retry policy
absorbs and the `StragglerDetector` watchdog over step times.  Training
runs `TrainLoop`: on a real cluster the failure signal is a runtime error
from the collective layer; here `FaultInjector` raises the same class of
error at chosen steps, so the recovery path runs end to end:

    fresh state -> N steps -> injected DeviceFailure -> restore(latest)
    -> data.seek(restored step) -> continue -> reach total_steps

Straggler detection: per-step wall times feed an online mean / variance; a
step slower than mean + z * std (and an absolute floor) is flagged and
`on_straggler` is called.  A loss that goes non-finite raises
`NanLossError` at once.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional

from ..checkpoint.manager import CheckpointError, CheckpointManager


class DeviceFailure(RuntimeError):
    """Stand-in for the runtime error a dead peer raises on real hardware."""


class NanLossError(RuntimeError):
    """The loss went non-finite: surfaced at once instead of training on
    garbage (the loop checks every metrics["loss"])."""


@dataclasses.dataclass
class FaultInjector:
    fail_at_steps: tuple = ()
    fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise DeviceFailure(f"simulated node failure at step {step}")


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


@dataclasses.dataclass
class TrainLoop:
    """Restartable step loop around a train step (`launch/steps.
    make_train_step`), JAX's loop step for step."""

    train_step: Callable  # (params, opt_state, batch) -> (params, opt_state, metrics)
    ckpt: CheckpointManager
    checkpoint_every: int = 50
    max_restarts: int = 10
    fault_injector: Optional[FaultInjector] = None
    straggler: StragglerDetector = dataclasses.field(default_factory=StragglerDetector)
    on_straggler: Optional[Callable[[int, float], None]] = None
    on_metrics: Optional[Callable[[int, Dict], None]] = None
    nan_policy: str = "raise"  # "raise" | "ignore"

    def _save(self, step, params, opt_state, history):
        # an EARLIER async save's failure surfaces here as CheckpointError;
        # the run goes on (a lost snapshot widens the replay window, it is
        # not a training failure), the event is logged, and the save that
        # raised it is retried once
        state = {"params": params, "opt": opt_state, "step": step}
        try:
            self.ckpt.save(step, state)
        except CheckpointError as e:
            history["ckpt_events"].append(("save_failed", e.step, repr(e.cause)))
            self.ckpt.save(step, state)

    def _drain(self, history):
        try:
            self.ckpt.wait()
        except CheckpointError as e:
            history["ckpt_events"].append(("save_failed", e.step, repr(e.cause)))

    def run(self, params, opt_state, data, total_steps: int, start_step: int = 0):
        """Runs to total_steps, surviving injected failures; returns
        (params, opt_state, history)."""
        step = start_step
        restarts = 0
        history: Dict[str, Any] = {"restarts": 0, "steps_run": 0,
                                   "stragglers": [], "ckpt_events": []}
        while step < total_steps:
            try:
                data.seek(step)
                while step < total_steps:
                    if self.fault_injector is not None:
                        self.fault_injector.check(step)
                    batch = data.next_batch()
                    t0 = time.perf_counter()
                    params, opt_state, metrics = self.train_step(params, opt_state, batch)
                    dt = time.perf_counter() - t0
                    history["steps_run"] += 1
                    if self.nan_policy == "raise" and "loss" in metrics:
                        lv = float(metrics["loss"])
                        if lv != lv or lv in (float("inf"), float("-inf")):
                            raise NanLossError(
                                f"non-finite loss at step {step} "
                                f"(last checkpoint: {self.ckpt.latest_step()})")
                    if self.straggler.observe(step, dt) and self.on_straggler:
                        self.on_straggler(step, dt)
                    if self.on_metrics:
                        self.on_metrics(step, metrics)
                    step += 1
                    if step % self.checkpoint_every == 0 or step == total_steps:
                        self._save(step, params, opt_state, history)
            except DeviceFailure:
                restarts += 1
                history["restarts"] = restarts
                if restarts > self.max_restarts:
                    raise
                # an async save may still be in flight; a failed one cannot
                # block recovery, and its event lands in history
                self._drain(history)
                latest = self.ckpt.latest_step()
                if latest is None:
                    step = start_step  # no checkpoint yet: cold restart
                    continue
                state = self.ckpt.restore({"params": params, "opt": opt_state, "step": 0})
                params, opt_state = state["params"], state["opt"]
                step = latest
        history["stragglers"] = list(self.straggler.flagged)
        self._drain(history)
        return params, opt_state, history
