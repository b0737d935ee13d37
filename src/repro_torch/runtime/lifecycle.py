"""Serving request lifecycle (port of `repro/runtime/lifecycle.py`).

The vocabulary the `ContinuousBatcher` (runtime/batcher) speaks:

  - `Request` with a full lifecycle: priority, step-denominated TTFT /
    total deadlines, cancellation, a per-request typed event log, and a
    typed `finish_reason`.  Every submitted request terminates with exactly
    one reason.
  - `RetryPolicy` for transient step failures and the per-step
    `StepHealth` watchdog record.

Deadlines are denominated in BATCHER STEPS, not wall seconds: the step is
the scheduler's clock tick, which makes expiry exactly reproducible.

Not ported yet: `ChaosInjector` / `ChaosConfig` / `ChaosStream`, the
serving-side fault injection (ROADMAP queue 1 item 13).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np



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
