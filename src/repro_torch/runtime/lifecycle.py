"""Serving request lifecycle and serving-side chaos injection (port of
`repro/runtime/lifecycle.py`).

The vocabulary the `ContinuousBatcher` (runtime/batcher) and the
`DisaggEngine` (runtime/disagg) speak:

  - `Request` with a full lifecycle: priority, step-denominated TTFT /
    total deadlines, cancellation, a per-request typed event log, and a
    typed `finish_reason`.  Every submitted request terminates with exactly
    one reason.
  - `RetryPolicy` for transient step failures and the per-step
    `StepHealth` watchdog record.
  - `ChaosInjector`: step-level fault injection (transient DeviceFailure,
    non-finite-logit poisoning of one slot, pool pressure that seizes free
    pages for a few steps, synthetic latency spikes for the watchdog, the
    disaggregated engine's worker kills, hangs and handoff drops, and SDC
    bit flips for the ABFT audit).  The schedule for step t is a pure
    function of (seed, t, stream): every draw comes from
    `np.random.default_rng([seed, t, stream])`, which carries no framework,
    so the port's schedules equal JAX's draw for draw, and requests the
    faults never touch decode the tokens of a fault-free run.

Deadlines are denominated in BATCHER STEPS, not wall seconds: the step is
the scheduler's clock tick, which makes expiry exactly reproducible.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .fault import DeviceFailure
from .kv_pages import PagePool


class FinishReason:
    """Typed terminal states.  Exactly one is set on every request that
    enters the batcher, including the ones the old code dropped on the
    floor (over-long prompts, requests still queued at max_steps)."""

    EOS = "eos"                      # hit the request's eos_id
    MAX_NEW = "max_new"              # generated max_new tokens
    MAX_LEN = "max_len"              # ran into the cache's max_len
    TRUNCATED = "truncated"          # page reservation exhausted mid-prefill
    DEADLINE = "deadline"            # step deadline expired / load-shed
    PREEMPTED_REQUEUED = "preempted_requeued"  # preempted, never re-admitted
    FAILED = "failed"                # quarantined (non-finite logits)
    CANCELLED = "cancelled"          # caller cancelled
    HANDOFF_FAILED = "handoff_failed"  # disagg handoff exhausted retries
    #                                    AND reroutes AND fallback disabled

    ALL = frozenset({EOS, MAX_NEW, MAX_LEN, TRUNCATED, DEADLINE,
                     PREEMPTED_REQUEUED, FAILED, CANCELLED,
                     HANDOFF_FAILED})
    # reasons that mean "the request delivered its tokens" (goodput)
    COMPLETED = frozenset({EOS, MAX_NEW, MAX_LEN})


class RequestState:
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    PREEMPTED = "preempted"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (L,) int32
    max_new: int
    eos_id: Optional[int] = None
    priority: int = 0                      # higher = more important
    deadline_steps: Optional[int] = None   # total budget, steps from submit
    ttft_steps: Optional[int] = None       # first-token budget from submit
    # filled by the batcher:
    output: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None
    state: str = RequestState.QUEUED
    submitted_at: int = -1
    first_token_at: Optional[int] = None
    finished_at: Optional[int] = None
    preemptions: int = 0
    events: List[Tuple[str, int]] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        """Back-compat view of the typed reason (the old bare flag)."""
        return self.finish_reason is not None

    def sequence(self) -> np.ndarray:
        """prompt + already-generated tokens: the token stream a resumed
        (preempted) request must have resident in cache.  For a fresh
        request this is just the prompt."""
        if not self.output:
            return np.asarray(self.prompt, np.int32)
        return np.concatenate(
            [np.asarray(self.prompt, np.int32),
             np.asarray(self.output, np.int32)])

    def log_event(self, kind: str, step: int) -> None:
        self.events.append((kind, step))

    def remaining_new(self) -> int:
        return max(self.max_new - len(self.output), 0)


@dataclasses.dataclass
class RetryPolicy:
    """Retry-with-backoff for transient step failures.  The device step
    writes the cache in place, but only the K/V rows at the step's own
    positions, computed from the step's own inputs: a retry rewrites the
    same rows with the same values, so it is a pure recompute."""

    max_retries: int = 3
    backoff_s: float = 0.0  # base; attempt k sleeps backoff * 2**(k-1)

    def delay(self, attempt: int) -> float:
        return self.backoff_s * (2 ** max(attempt - 1, 0))


@dataclasses.dataclass
class StepHealth:
    """One watchdog record per batcher step."""

    step: int
    dt_s: float = 0.0
    active: int = 0
    queued: int = 0
    pages_free: Optional[int] = None
    retries: int = 0
    poisoned: List[int] = dataclasses.field(default_factory=list)   # rids
    preempted: List[int] = dataclasses.field(default_factory=list)  # rids
    shed: List[int] = dataclasses.field(default_factory=list)       # rids
    straggler: bool = False
    chaos: List[str] = dataclasses.field(default_factory=list)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ChaosEvent:
    step: int
    kind: str
    detail: str = ""


class ChaosStream:
    """Named rng stream ids for `ChaosInjector._rng(step, stream)`.

    Every fault family draws from its own `default_rng([seed, step, id])`
    stream so schedules are independent: turning one fault on never shifts
    another's draws.  These ids used to live as bare literals at each call
    site with only a comment tying them together; any two families sharing
    an id would silently correlate their schedules, so the ids are
    centralized here and the no-collision property is asserted at import.
    """

    STEP_FAILURE = 0    # transient DeviceFailure gate
    POISON_GATE = 1     # non-finite-logit poisoning gate
    POISON_VICTIM = 2   # ... victim slot choice
    LATENCY = 3         # synthetic watchdog latency spike gate
    PRESSURE = 4        # pool-pressure episode gate
    KILL_GATE = 5       # disagg worker kill gate
    KILL_VICTIM = 6     # ... victim worker choice
    HANG_GATE = 7       # disagg worker hang gate
    HANG_VICTIM = 8     # ... victim worker choice
    HANDOFF_DROP = 9    # disagg handoff drop gate
    BITFLIP_GATE = 10   # SDC bit-flip gate (ABFT chaos stream)
    BITFLIP_SITE = 11   # ... flip site + sign/magnitude draws

    ALL = (STEP_FAILURE, POISON_GATE, POISON_VICTIM, LATENCY, PRESSURE,
           KILL_GATE, KILL_VICTIM, HANG_GATE, HANG_VICTIM, HANDOFF_DROP,
           BITFLIP_GATE, BITFLIP_SITE)


# Two families sharing a stream id would correlate their fault schedules
# (same rng draws); fail loudly at import time, not in a flaky chaos run.
assert len(set(ChaosStream.ALL)) == len(ChaosStream.ALL), \
    "ChaosStream ids must be pairwise distinct"


@dataclasses.dataclass
class ChaosConfig:
    """Fault mix.  Rates draw from per-(seed, step) rng streams; the
    ``*_at_steps`` schedules are the deterministic variant the exactness
    tests use (rate and schedule compose with `or`)."""

    seed: int = 0
    step_failure_rate: float = 0.0     # P(transient DeviceFailure per step)
    fail_at_steps: tuple = ()
    poison_rate: float = 0.0           # P(one slot's logits go non-finite)
    poison_at_steps: tuple = ()
    pool_pressure_rate: float = 0.0    # P(start a page-seizure episode)
    pressure_at_steps: tuple = ()
    pool_pressure_pages: int = 0       # pages seized per episode
    pool_pressure_steps: int = 3       # episode length in steps
    latency_spike_rate: float = 0.0    # P(synthetic watchdog spike)
    latency_spike_s: float = 0.25      # spike size fed to the detector
    # ---- disagg worker faults (runtime/disagg.DisaggEngine) ----
    worker_kill_rate: float = 0.0      # P(kill one live prefill worker)
    kill_worker_at: tuple = ()         # ((step, wid), ...) deterministic
    worker_hang_rate: float = 0.0      # P(hang one live prefill worker)
    hang_worker_at: tuple = ()         # ((step, wid, steps), ...)
    worker_hang_steps: int = 3         # default hang length (rate path)
    handoff_drop_rate: float = 0.0     # P(a handoff attempt is dropped)
    drop_handoff_at: tuple = ()        # (step, ...) deterministic
    # ---- SDC bit flips (ABFT detection path; runtime/batcher --abft) ----
    bitflip_rate: float = 0.0          # P(one SDC bit flip per step)
    bitflip_at_steps: tuple = ()       # deterministic schedule variant
    bitflip_exponent: int = 14         # |delta| = 2**e: an exponent-bit-
    #   flip surrogate, large enough to clear the float-path ABFT
    #   tolerance at any realistic operand scale (see kernels/abft.py)


class ChaosInjector:
    """Deterministic, step-keyed fault injection for `ContinuousBatcher`.

    Every decision for step t comes from `default_rng([seed, t, stream])`,
    so the schedule does not depend on how many draws earlier steps made —
    two runs with the same seed inject the same faults at the same steps,
    and requests the faults never touch decode identical tokens (greedy
    decode is exact; slot isolation is already asserted by the batcher
    suite).

    Pool pressure seizes `pool_pressure_pages` pages under a sentinel slot
    id for `pool_pressure_steps` steps — from the scheduler's point of
    view this is indistinguishable from real exhaustion, so it drives the
    preemption/recompute path end to end.
    """

    PRESSURE_SLOT = -99  # sentinel pool slot (never rendered into tables)

    def __init__(self, config: ChaosConfig):
        self.cfg = config
        self.events: List[ChaosEvent] = []
        self._pressure_until: Optional[int] = None
        # counters for health / bench reporting
        self.failures_injected = 0
        self.poisons_injected = 0
        self.pressure_episodes = 0
        self.spikes_injected = 0
        self.worker_kills_injected = 0
        self.worker_hangs_injected = 0
        self.handoff_drops_injected = 0
        self.bitflips_injected = 0

    def _rng(self, step: int, stream: int) -> np.random.Generator:
        return np.random.default_rng([self.cfg.seed, int(step), stream])

    # ---- pure per-step predicates (shared by the mutating methods and
    # the plan() inspection view; stream ids are the ChaosStream named
    # constants — one independent rng stream per fault family) ----

    def _wants_step_failure(self, step: int) -> bool:
        return step in self.cfg.fail_at_steps or (
            self.cfg.step_failure_rate > 0
            and bool(self._rng(step, ChaosStream.STEP_FAILURE).random()
                     < self.cfg.step_failure_rate))

    def _wants_poison(self, step: int) -> bool:
        return step in self.cfg.poison_at_steps or (
            self.cfg.poison_rate > 0
            and bool(self._rng(step, ChaosStream.POISON_GATE).random()
                     < self.cfg.poison_rate))

    def _wants_spike(self, step: int) -> bool:
        return (self.cfg.latency_spike_rate > 0
                and bool(self._rng(step, ChaosStream.LATENCY).random()
                         < self.cfg.latency_spike_rate))

    def _wants_pressure(self, step: int) -> bool:
        return step in self.cfg.pressure_at_steps or (
            self.cfg.pool_pressure_rate > 0
            and bool(self._rng(step, ChaosStream.PRESSURE).random()
                     < self.cfg.pool_pressure_rate))

    def _scheduled_kills(self, step: int) -> List[int]:
        return [int(w) for (s, w) in self.cfg.kill_worker_at if s == step]

    def _wants_worker_kill(self, step: int) -> bool:
        return (self.cfg.worker_kill_rate > 0
                and bool(self._rng(step, ChaosStream.KILL_GATE).random()
                         < self.cfg.worker_kill_rate))

    def _scheduled_hangs(self, step: int) -> List[Tuple[int, int]]:
        return [(int(w), int(n))
                for (s, w, n) in self.cfg.hang_worker_at if s == step]

    def _wants_worker_hang(self, step: int) -> bool:
        return (self.cfg.worker_hang_rate > 0
                and bool(self._rng(step, ChaosStream.HANG_GATE).random()
                         < self.cfg.worker_hang_rate))

    def _wants_handoff_drop(self, step: int) -> bool:
        return step in self.cfg.drop_handoff_at or (
            self.cfg.handoff_drop_rate > 0
            and bool(self._rng(step, ChaosStream.HANDOFF_DROP).random()
                     < self.cfg.handoff_drop_rate))

    def _wants_bitflip(self, step: int) -> bool:
        return step in self.cfg.bitflip_at_steps or (
            self.cfg.bitflip_rate > 0
            and bool(self._rng(step, ChaosStream.BITFLIP_GATE).random()
                     < self.cfg.bitflip_rate))

    def plan(self, step: int) -> dict:
        """Pure inspection of the fault schedule for `step`: what WOULD be
        injected, with no counters bumped and no events recorded.  Victim
        choices that depend on runtime state (which slots are active, which
        workers are alive) are reported as gate booleans plus any
        statically scheduled victims; pressure is reported as the gate
        signal (an already-running episode suppresses a new one at
        injection time).  Chaos test failures print this so a red run
        states what was injected (see tests/test_lifecycle.py)."""
        return {
            "step": int(step),
            "step_failure": self._wants_step_failure(step),
            "poison": self._wants_poison(step),
            "latency_spike": self._wants_spike(step),
            "pool_pressure": self._wants_pressure(step),
            "worker_kill": self._wants_worker_kill(step),
            "worker_kill_scheduled": self._scheduled_kills(step),
            "worker_hang": self._wants_worker_hang(step),
            "worker_hang_scheduled": self._scheduled_hangs(step),
            "handoff_drop": self._wants_handoff_drop(step),
            "bitflip": self._wants_bitflip(step),
        }

    # ---- per-step decisions ----

    def wants_failure(self, step: int) -> bool:
        hit = self._wants_step_failure(step)
        if hit:
            self.failures_injected += 1
            self.events.append(ChaosEvent(step, "step_failure"))
        return hit

    def make_failure(self, step: int) -> DeviceFailure:
        return DeviceFailure(f"chaos: injected step failure at step {step}")

    def poison_slot(self, step: int, active_slots: List[int]) -> Optional[int]:
        """Pick one active slot whose logits come back non-finite this
        step (None = no poisoning).  The victim choice is part of the
        (seed, step) schedule."""
        if not active_slots or not self._wants_poison(step):
            return None
        victim = int(active_slots[int(self._rng(
            step, ChaosStream.POISON_VICTIM).integers(len(active_slots)))])
        self.poisons_injected += 1
        self.events.append(ChaosEvent(step, "poison", f"slot={victim}"))
        return victim

    def latency_spike(self, step: int) -> float:
        """Synthetic seconds to add to the watchdog's observed step time
        (no real sleep: the detector sees the spike, the suite stays
        fast)."""
        if self._wants_spike(step):
            self.spikes_injected += 1
            self.events.append(ChaosEvent(step, "latency_spike",
                                          f"{self.cfg.latency_spike_s}s"))
            return self.cfg.latency_spike_s
        return 0.0

    # ---- disagg worker faults ----

    def kill_worker(self, step: int, alive: List[int]) -> List[int]:
        """Worker ids to kill this step: every scheduled (step, wid) pair
        whose wid is still alive, plus (rate path) one rng-chosen victim.
        The victim draw is part of the (seed, step) schedule."""
        victims = [w for w in self._scheduled_kills(step) if w in alive]
        if alive and self._wants_worker_kill(step):
            pick = int(alive[int(self._rng(
                step, ChaosStream.KILL_VICTIM).integers(len(alive)))])
            if pick not in victims:
                victims.append(pick)
        for w in victims:
            self.worker_kills_injected += 1
            self.events.append(ChaosEvent(step, "worker_kill", f"wid={w}"))
        return victims

    def hang_worker(self, step: int,
                    candidates: List[int]) -> List[Tuple[int, int]]:
        """(wid, hang_steps) pairs for workers that stop heartbeating this
        step but resume once the hang expires (a straggler, not a corpse)."""
        hangs = [(w, n) for (w, n) in self._scheduled_hangs(step)
                 if w in candidates]
        if candidates and self._wants_worker_hang(step):
            pick = int(candidates[int(self._rng(
                step, ChaosStream.HANG_VICTIM).integers(len(candidates)))])
            if pick not in [w for w, _ in hangs]:
                hangs.append((pick, self.cfg.worker_hang_steps))
        for w, n in hangs:
            self.worker_hangs_injected += 1
            self.events.append(ChaosEvent(step, "worker_hang",
                                          f"wid={w} steps={n}"))
        return hangs

    def drops_handoff(self, step: int) -> bool:
        """Whether a handoff attempt at `step` is dropped in flight.  One
        decision per step (pure in (seed, step)): every attempt made at a
        dropping step fails, and the backed-off retry at a later step draws
        fresh."""
        hit = self._wants_handoff_drop(step)
        if hit:
            self.handoff_drops_injected += 1
            self.events.append(ChaosEvent(step, "handoff_drop"))
        return hit

    # ---- SDC bit flips (the ABFT chaos stream) ----

    def _flip_delta(self, rng: np.random.Generator) -> float:
        """Signed exponent-bit-flip surrogate: +/- 2**bitflip_exponent.
        Real SDCs that matter are high-order-bit flips (low-order flips
        vanish into rounding noise and are below any sound tolerance);
        the magnitude clears the float-path ABFT tolerance by orders of
        magnitude at any realistic operand scale."""
        sign = 1.0 if bool(rng.integers(2)) else -1.0
        return sign * float(2.0 ** int(self.cfg.bitflip_exponent))

    def bitflip(self, step: int, shape: Tuple[int, ...]):
        """Corruption for a host-side array of `shape` this step, or None.
        Returns (index_tuple, delta): the batcher applies the delta to its
        host logits copy before token derivation, and the ABFT checksum
        compare against the device array must catch it.  Pure in
        (seed, step) given the shape."""
        if not self._wants_bitflip(step) or any(d <= 0 for d in shape):
            return None
        rng = self._rng(step, ChaosStream.BITFLIP_SITE)
        idx = tuple(int(rng.integers(int(d))) for d in shape)
        delta = self._flip_delta(rng)
        self.bitflips_injected += 1
        self.events.append(ChaosEvent(step, "bitflip",
                                      f"site={idx} delta={delta:g}"))
        return idx, delta

    def gemm_fault(self, step: int):
        """`TileFault` to thread into a checksummed GEMM dispatch at this
        step (attempt 0 only — the transient-SDC model), or None.  Tile
        and in-tile coordinates are drawn wide and reduced mod the actual
        grid/tile sizes at dispatch (kernels/abft.build_fault_operands),
        so the stream needs no knowledge of the GEMM shape."""
        if not self._wants_bitflip(step):
            return None
        from ..kernels.abft import TileFault

        rng = self._rng(step, ChaosStream.BITFLIP_SITE)
        coords = [int(v) for v in rng.integers(2 ** 16, size=4)]
        fault = TileFault(coords[0], coords[1], coords[2], coords[3],
                          self._flip_delta(rng))
        self.bitflips_injected += 1
        self.events.append(ChaosEvent(
            step, "bitflip",
            f"tile=({fault.tile_i},{fault.tile_j}) "
            f"rc=({fault.row},{fault.col}) delta={fault.delta:g}"))
        return fault

    # ---- pool-pressure episodes ----

    def begin_step(self, step: int, pool: Optional[PagePool]) -> None:
        """Advance pressure-episode state.  Called at the top of every
        batcher step, before admission, so a fresh episode back-pressures
        (or preempts) THIS step's admissions."""
        if pool is None:
            return
        if self._pressure_until is not None and step >= self._pressure_until:
            pool.release(self.PRESSURE_SLOT)
            self._pressure_until = None
            self.events.append(ChaosEvent(step, "pool_pressure_off"))
        if self._pressure_until is not None:
            return
        if not (self._wants_pressure(step)
                and self.cfg.pool_pressure_pages > 0):
            return
        tokens = self.cfg.pool_pressure_pages * pool.page_size
        if pool.try_reserve(self.PRESSURE_SLOT, tokens) is None:
            self.events.append(ChaosEvent(step, "pool_pressure_skipped",
                                          "pool already exhausted"))
            return
        self._pressure_until = step + self.cfg.pool_pressure_steps
        self.pressure_episodes += 1
        self.events.append(ChaosEvent(
            step, "pool_pressure_on",
            f"{self.cfg.pool_pressure_pages} pages for "
            f"{self.cfg.pool_pressure_steps} steps"))

    def end(self, pool: Optional[PagePool]) -> None:
        """Release any held pressure reservation (end of a serving run)."""
        if pool is not None and self._pressure_until is not None:
            pool.release(self.PRESSURE_SLOT)
            self._pressure_until = None

    def summary(self) -> dict:
        return {
            "failures_injected": self.failures_injected,
            "poisons_injected": self.poisons_injected,
            "pressure_episodes": self.pressure_episodes,
            "spikes_injected": self.spikes_injected,
            "worker_kills_injected": self.worker_kills_injected,
            "worker_hangs_injected": self.worker_hangs_injected,
            "handoff_drops_injected": self.handoff_drops_injected,
            "bitflips_injected": self.bitflips_injected,
            "events": len(self.events),
        }
