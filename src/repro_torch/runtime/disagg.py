"""Disaggregated prefill/decode serving with fault-tolerant page handoff
(port of `repro/runtime/disagg.py`).

Production engines split serving into a prefill pool (compute-bound: long
prompt GEMMs) and a decode pool (bandwidth-bound: one token per step at
high occupancy), so neither phase stalls the other.  The expensive part of
that split is moving the prefilled KV state across.  This engine makes the
move a *metadata* operation: operands already resident are referenced, not
re-streamed.

  - **Shared-pool handoff (default)**: N simulated prefill workers and the
    decode `ContinuousBatcher` allocate from ONE refcounted `PagePool` and
    one `PrefixIndex`.  A worker prefills a request's prompt into its own
    pages (`DecoderLM.prefill_step_paged`, batch 1 under a private high
    slot id), then hands off by incref-publish-mount: its FULL pages are
    published into the index (incref = the pin), the reservation is
    released, and decode admission re-mounts the published span as shared
    pages -- zero tensor copies, the handoff ships only the page table.
    The <= page_size-1 unpublished tail rows are re-prefilled decode-side,
    and the prompt's last token rides the decode step exactly like every
    other admission path.
  - **Page migration (``shared_pool=False``)**: disjoint pools (separate
    physical caches).  Handoff copies the full pages' rows from the
    prefill cache into the decode cache, in place along the page axis of
    every leaf (the int8 / fp8 scale pages included), and mounts them in
    the decode pool; ``migrated_pages`` counts them (their pricing, JAX's
    `core.transfer_model.PageMigration`, comes with the analytics, ROADMAP
    queue 1 item 9).

Robustness:

  - per-worker heartbeats: a busy worker that has not advanced a chunk
    within ``heartbeat_timeout`` engine steps is declared lost; a
    per-worker `StragglerDetector` scores launch latency for the health
    report.  It does NOT steer dispatch: it times an asynchronous launch
    (on the card, the enqueue), and dispatch must stay a pure function of
    the schedule so chaos runs decode the tokens of a fault-free run.
  - `ChaosInjector` worker faults: kill (permanent), hang (stops
    heartbeating, resumes later), and handoff drops -- all pure functions
    of (seed, step), logged into the per-request event log.
  - crashed-worker recovery: the victim's COMPLETED full pages are
    republished through the `PrefixIndex` before its reservation is
    released, so the re-dispatched request remounts them and recomputes
    only the tail.
  - handoff retry-with-backoff, then rerouting (republish + re-dispatch),
    then decode-side fallback; `FinishReason.HANDOFF_FAILED` only when
    fallback is disabled and every route is exhausted.
  - graceful degradation: when ALL prefill workers are observed unhealthy
    the decode pool absorbs chunked prefill directly
    (``degraded_admit_per_step`` requests per step).

The engine's clock is the decode batcher's step counter (`step()` runs the
batcher exactly once), so deadlines, heartbeats, and backoffs are all
denominated in the same reproducible unit.  The engine runs on the device
of the params.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from .batcher import ContinuousBatcher
from .fault import StragglerDetector
from .kv_pages import PagePool
from .lifecycle import ChaosInjector, FinishReason, Request, RequestState, RetryPolicy
from .prefix_cache import PrefixIndex

__all__ = ["DisaggEngine"]

WORKER_SLOT_BASE = 10_000   # pool slot id of prefill worker w: BASE + w
HANDOFF_SLOT_BASE = 20_000  # staged handoff for request r: BASE + r.rid
MIGRATE_STAGE_SLOT = 99_999  # decode-pool landing reservation (migration)

_HEALTHY = "healthy"
_DEAD = "dead"


@dataclasses.dataclass
class _Worker:
    wid: int
    slot: int
    state: str = _HEALTHY           # true state (chaos-written)
    hung_until: Optional[int] = None
    suspected: bool = False         # engine-OBSERVED health
    req: Optional[Request] = None
    seq: Optional[np.ndarray] = None
    pos: int = 0                    # rows prefilled so far
    target: int = 0                 # rows to prefill (len(seq) - 1)
    last_beat: int = 0
    launches: int = 0
    detector: StragglerDetector = dataclasses.field(
        default_factory=StragglerDetector)

    @property
    def busy(self) -> bool:
        return self.req is not None


@dataclasses.dataclass
class _Handoff:
    req: Request
    wid: int
    slot: int           # staging slot id holding the pages
    seq: np.ndarray
    written: int        # rows resident under `slot`
    attempts: int = 0
    next_try: int = 0


class DisaggEngine:
    """Two-pool serving engine: N prefill workers + one decode batcher.

    ``shared_pool=True``: one `PagePool` / `PrefixIndex` / physical cache
    for both pools; handoff is incref-publish-mount, no tensor copy.
    ``shared_pool=False``: the prefill side gets its own pool and cache
    ((prefill_workers + 2) x max_len's pages) and handoff migrates full
    pages into the decode pool (count surfaced as ``migrated_pages``).

    ``prefill_chunk`` (>= 1) is both the workers' tokens-per-launch and
    the decode batcher's tail/degraded-mode prefill chunk.  ``chaos`` and
    ``retry`` are shared with the batcher, so one (seed, step) schedule
    covers decode faults and worker faults.  ``cache_dtype`` is a torch
    dtype."""

    def __init__(self, model, params, *, prefill_workers: int = 2,
                 batch_slots: int = 4, max_len: int = 128,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 prefill_chunk: int = 8, shared_pool: bool = True,
                 cache_dtype=torch.float32, kv_quant=None,
                 prefix_max_pinned: Optional[int] = None,
                 chaos: Optional[ChaosInjector] = None,
                 retry: Optional[RetryPolicy] = None,
                 heartbeat_timeout: int = 3,
                 handoff_max_retries: int = 3,
                 handoff_backoff_steps: int = 1,
                 reroutes_max: int = 2,
                 degraded_fallback: bool = True,
                 degraded_admit_per_step: int = 1):
        if prefill_workers < 1:
            raise ValueError("need at least one prefill worker")
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1 (the workers and "
                             "the degraded-mode fallback prefill in chunks)")
        self.model = model
        self.params = params
        self.ps = int(page_size)
        self.shared_pool = bool(shared_pool)
        self._table_width = -(-max_len // self.ps)
        self.chaos = chaos
        self.heartbeat_timeout = int(heartbeat_timeout)
        self.handoff_max_retries = int(handoff_max_retries)
        self.handoff_backoff_steps = max(int(handoff_backoff_steps), 1)
        self.reroutes_max = int(reroutes_max)
        self.degraded_fallback = bool(degraded_fallback)
        self.degraded_admit_per_step = max(int(degraded_admit_per_step), 1)

        if num_pages is None:
            # decode slots at full depth + one in-flight prompt per worker
            # + headroom for staged handoffs awaiting delivery
            num_pages = (batch_slots + prefill_workers + 2) * self._table_width
        if shared_pool:
            self.pool_p = PagePool(num_pages, self.ps)
            self.index_p = PrefixIndex(self.pool_p, max_pinned_pages=prefix_max_pinned)
            self.batcher = ContinuousBatcher(
                model, params, batch_slots, max_len, cache_dtype,
                paged=True, prefill_chunk=prefill_chunk,
                pool=self.pool_p, prefix_index=self.index_p,
                kv_quant=kv_quant, chaos=chaos, retry=retry)
            self.pool_d = self.pool_p
            self.index_d = self.index_p
            self.cache_p = None  # prefill writes into batcher.cache
        else:
            self.batcher = ContinuousBatcher(
                model, params, batch_slots, max_len, cache_dtype,
                paged=True, page_size=self.ps, num_pages=num_pages,
                prefill_chunk=prefill_chunk, prefix_cache=True,
                prefix_max_pinned=prefix_max_pinned,
                kv_quant=kv_quant, chaos=chaos, retry=retry)
            self.pool_d = self.batcher.pool
            self.index_d = self.batcher.prefix
            prefill_pages = (prefill_workers + 2) * self._table_width
            self.pool_p = PagePool(prefill_pages, self.ps)
            self.index_p = PrefixIndex(self.pool_p, max_pinned_pages=prefix_max_pinned)
            self.cache_p = model.make_paged_cache(
                self.pool_p.total_pages, self.ps, dtype=cache_dtype,
                device=self.batcher.device, kv_quant=kv_quant)

        self.workers = [
            _Worker(wid=w, slot=WORKER_SLOT_BASE + w)
            for w in range(prefill_workers)
        ]
        self.queue: Deque[Request] = deque()
        self.handoffs: List[_Handoff] = []
        # counters
        self.accepted = 0
        self.prefill_launches = 0
        self.handoffs_completed = 0
        self.handoff_drops = 0
        self.reroutes = 0
        self.recoveries = 0
        self.degraded_forwards = 0
        self.migrated_pages = 0
        self.bypassed = 0  # single-token prompts sent straight to decode

    # ------------------------------------------------------------------
    # lifecycle entry points
    # ------------------------------------------------------------------

    @property
    def now(self) -> int:
        return self.batcher.steps_run

    @property
    def finished(self) -> Dict[int, Request]:
        return self.batcher.finished

    def submit(self, req: Request) -> None:
        """Accept a request into the prefill queue.  `submitted_at` is
        stamped HERE (the shared engine/batcher clock), so TTFT and
        deadlines cover worker queueing and prefill, not just the
        decode-side wait."""
        req.submitted_at = self.now
        req.state = RequestState.QUEUED
        req.log_event("accepted", self.now)
        req._reroutes = 0
        self.queue.append(req)
        self.accepted += 1

    def step(self) -> int:
        """One engine step: worker faults -> health detection/recovery ->
        engine-side deadline expiry -> handoff pump -> dispatch -> worker
        prefill advance -> handoff pump (same-step delivery) -> ONE decode
        batcher step.  Returns the batcher's active slot count."""
        now = self.now
        self._inject_worker_faults(now)
        self._detect_and_recover(now)
        self._expire_engine_side(now)
        self._pump_handoffs(now)
        self._dispatch(now)
        self._advance_workers(now)
        self._pump_handoffs(now)
        return self.batcher.step()

    def run_to_completion(self, max_steps: int = 10_000) -> Dict[int, Request]:
        """Drain everything.  Hitting max_steps finalizes engine-held
        requests the same way the batcher does -- typed DEADLINE (or
        PREEMPTED_REQUEUED for a request a recovery requeued), never a
        silent drop."""
        steps = 0
        while steps < max_steps and (
                self.queue or self.handoffs
                or any(w.busy for w in self.workers)
                or self.batcher.queue or self.batcher.active):
            self.step()
            steps += 1
        if (self.queue or self.handoffs
                or any(w.busy for w in self.workers)):
            for w in self.workers:
                if w.busy:
                    self.pool_p.release(w.slot)
                    self.batcher._finalize(w.req, FinishReason.DEADLINE)
                    self._clear(w)
            for h in self.handoffs:
                self.pool_p.release(h.slot)
                self.batcher._finalize(h.req, FinishReason.DEADLINE)
            self.handoffs.clear()
            while self.queue:
                req = self.queue.popleft()
                self.batcher._finalize(
                    req,
                    FinishReason.PREEMPTED_REQUEUED if req.preemptions
                    else FinishReason.DEADLINE)
        self.batcher.run_to_completion(max(max_steps - steps, 0))
        return self.batcher.finished

    @staticmethod
    def _clear(w: _Worker) -> None:
        w.req = None
        w.seq = None
        w.pos = w.target = 0

    # ------------------------------------------------------------------
    # chaos + health
    # ------------------------------------------------------------------

    def _inject_worker_faults(self, now: int) -> None:
        if self.chaos is None:
            return
        alive = [w.wid for w in self.workers if w.state == _HEALTHY]
        for wid in self.chaos.kill_worker(now, alive):
            w = self.workers[wid]
            w.state = _DEAD
            if w.req is not None:
                w.req.log_event(f"chaos_worker_kill:w{wid}", now)
        hangable = [w.wid for w in self.workers
                    if w.state == _HEALTHY and w.hung_until is None]
        for wid, steps in self.chaos.hang_worker(now, hangable):
            w = self.workers[wid]
            w.hung_until = now + steps
            if w.req is not None:
                w.req.log_event(f"chaos_worker_hang:w{wid}", now)

    def _detect_and_recover(self, now: int) -> None:
        """Heartbeat watchdog.  A busy worker silent past the timeout is
        declared lost: its request's COMPLETED full pages are republished
        through the prefix index, its reservation is released, and the
        request re-enters the queue head -- the re-dispatch remounts the
        published pages and recomputes only the partial tail."""
        for w in self.workers:
            if not w.busy or w.suspected:
                continue
            if now - w.last_beat <= self.heartbeat_timeout:
                continue
            w.suspected = True
            req = w.req
            req.log_event(f"worker_lost:w{w.wid}", now)
            full = w.pos // self.ps
            if full > 0:
                self.index_p.insert(w.seq[:full * self.ps], self.pool_p.owned(w.slot))
            self.pool_p.release(w.slot)
            self._clear(w)
            self.recoveries += 1
            self.queue.appendleft(req)

    # ------------------------------------------------------------------
    # deadlines (engine-side; the batcher handles its own)
    # ------------------------------------------------------------------

    @staticmethod
    def _expired(req: Request, now: int) -> bool:
        waited = now - req.submitted_at
        return ((req.deadline_steps is not None
                 and waited >= req.deadline_steps)
                or (req.ttft_steps is not None and not req.output
                    and waited >= req.ttft_steps))

    def _expire_engine_side(self, now: int) -> None:
        for req in [r for r in self.queue if self._expired(r, now)]:
            self.queue.remove(req)
            req.log_event("expired", now)
            self.batcher._finalize(req, FinishReason.DEADLINE)
        for w in self.workers:
            if w.busy and self._expired(w.req, now):
                self.pool_p.release(w.slot)
                w.req.log_event("expired", now)
                self.batcher._finalize(w.req, FinishReason.DEADLINE)
                self._clear(w)
        for h in [h for h in self.handoffs if self._expired(h.req, now)]:
            self.handoffs.remove(h)
            self.pool_p.release(h.slot)
            h.req.log_event("expired", now)
            self.batcher._finalize(h.req, FinishReason.DEADLINE)

    # ------------------------------------------------------------------
    # dispatch + prefill
    # ------------------------------------------------------------------

    def _dispatch(self, now: int) -> None:
        eligible = [w for w in self.workers if not w.suspected]
        if not eligible:
            # degraded mode: every worker is observed unhealthy, so the
            # decode pool absorbs chunked prefill itself -- at a reduced
            # admission rate instead of failing requests
            if self.degraded_fallback:
                for _ in range(self.degraded_admit_per_step):
                    if not self.queue:
                        break
                    req = self.queue.popleft()
                    req.log_event("degraded_forward", now)
                    self.degraded_forwards += 1
                    self.batcher.submit(req)
            return
        idle = sorted((w for w in eligible if not w.busy),
                      key=lambda w: (w.launches, w.wid))
        for w in idle:
            while self.queue and not w.busy:
                req = self.queue.popleft()
                outcome = self._assign(w, req, now)
                if outcome == "backpressure":
                    self.queue.appendleft(req)
                    return
            if not self.queue:
                return

    def _assign(self, w: _Worker, req: Request, now: int) -> str:
        """Mount the request on worker `w`.  Returns "assigned",
        "bypassed" (nothing to prefill: the prompt's only token rides the
        decode step), or "backpressure" (prefill pool cannot cover the
        reservation; the request stays queued, FIFO kept)."""
        seq = req.sequence()
        target = len(seq) - 1
        if target <= 0:
            req.log_event("prefill_bypass", now)
            self.bypassed += 1
            self.batcher.submit(req)
            return "bypassed"
        hit = self.index_p.lookup(seq)
        shared = list(hit.pages)  # full pages only; COW stays decode-side
        need = self.pool_p.pages_for(target) - len(shared)
        short = need - self.pool_p.pages_free
        if short > 0:
            self.index_p.evict(short, exclude=shared)
        if self.pool_p.try_reserve(w.slot, target, shared=shared) is None:
            return "backpressure"
        matched = len(shared) * self.ps
        self.index_p.note(matched)
        w.req = req
        w.seq = seq
        w.pos = matched
        w.target = target
        w.last_beat = now
        if matched:
            self.pool_p.set_length(w.slot, matched)
        req.state = RequestState.PREFILL
        req.log_event(f"dispatched:w{w.wid}", now)
        return "assigned"

    @property
    def _prefill_cache(self):
        return self.batcher.cache if self.shared_pool else self.cache_p

    def _advance_workers(self, now: int) -> None:
        """One chunk launch per responsive busy worker; the launch IS the
        heartbeat.  A dead worker never advances (its silence is what the
        watchdog detects); a hung one resumes after its hang expires and
        rejoins the eligible set.  The chunk runs eagerly, batch 1 under
        the worker's slot id, and writes the prefill cache in place (JAX
        jits the step)."""
        for w in self.workers:
            if w.state == _DEAD:
                continue
            if w.hung_until is not None:
                if now < w.hung_until:
                    continue
                w.hung_until = None
                w.last_beat = now
                w.suspected = False  # recovered work was already requeued
            if not w.busy:
                continue
            if w.pos < w.target:
                c = min(self.batcher.prefill_chunk, w.target - w.pos)
                toks = self.batcher._dev(w.seq[w.pos:w.pos + c][None, :].astype(np.int64))
                table = self.batcher._dev(self.pool_p.slot_table(w.slot, self._table_width))
                t0 = time.perf_counter()
                self.model.prefill_step_paged(
                    self.params, toks, self._prefill_cache,
                    self.batcher._dev(np.asarray([w.pos], np.int64)), table)
                w.detector.observe(now, time.perf_counter() - t0)
                w.pos += c
                self.pool_p.set_length(w.slot, w.pos)
                w.launches += 1
                self.prefill_launches += 1
            w.last_beat = now
            if w.pos >= w.target:
                self._stage_handoff(w, now)

    def _stage_handoff(self, w: _Worker, now: int) -> None:
        """Park the finished pages under a per-request staging id (pure
        metadata: `PagePool.transfer`), freeing the worker for its next
        prompt while the handoff is in flight."""
        stage = HANDOFF_SLOT_BASE + w.req.rid
        self.pool_p.transfer(w.slot, stage)
        # staged freight, not live serving state: its tokens report under
        # tokens_parked until delivery mounts (or a drop releases) them
        self.pool_p.park(stage)
        w.req.log_event("prefill_done", now)
        self.handoffs.append(_Handoff(
            req=w.req, wid=w.wid, slot=stage, seq=w.seq, written=w.pos,
            next_try=now))
        self._clear(w)

    # ------------------------------------------------------------------
    # handoff
    # ------------------------------------------------------------------

    def _pump_handoffs(self, now: int) -> None:
        for h in list(self.handoffs):
            if now < h.next_try:
                continue
            if self.chaos is not None and self.chaos.drops_handoff(now):
                h.attempts += 1
                self.handoff_drops += 1
                h.req.log_event("chaos_handoff_drop", now)
                if h.attempts > self.handoff_max_retries:
                    self.handoffs.remove(h)
                    self._reroute(h, now)
                else:
                    h.next_try = now + (self.handoff_backoff_steps
                                        * 2 ** (h.attempts - 1))
                continue
            if not self._deliver(h, now):
                h.next_try = now + 1  # decode pool full: retry, not a drop
                continue
            self.handoffs.remove(h)

    def _migrate_pages(self, dst: List[int], src: List[int]) -> None:
        """Copy prefill-cache pages `src` into decode-cache pages `dst`, in
        place along the page axis (1) of every leaf: K, V and, under
        kv_quant, their scale pages.  Only the full pages' ids are copied;
        JAX pads both id vectors to the table width with duplicate dump-page
        ids so that its jitted copy traces once."""
        dev = self.batcher.device
        d_idx = torch.as_tensor(dst, dtype=torch.int64, device=dev)
        s_idx = torch.as_tensor(src, dtype=torch.int64, device=dev)
        for name, seg in self.batcher.cache.items():
            for leaf, t in seg.items():
                t.index_copy_(1, d_idx, self.cache_p[name][leaf].index_select(1, s_idx))

    def _deliver(self, h: _Handoff, now: int) -> bool:
        full = h.written // self.ps
        if self.shared_pool:
            # incref-publish-mount: inserting pins the pages, releasing the
            # staging reservation drops only its reference -- no copy, the
            # decode admission remounts the same physical pages
            if full > 0:
                self.index_p.insert(h.seq[:full * self.ps], self.pool_p.owned(h.slot))
            self.pool_p.release(h.slot)
        else:
            if full > 0:
                src = self.pool_p.owned(h.slot)[:full]
                short = full - self.pool_d.pages_free
                if short > 0:
                    self.index_d.evict(short)
                dst = self.pool_d.try_reserve(MIGRATE_STAGE_SLOT, full * self.ps)
                if dst is None:
                    return False
                self._migrate_pages(dst, src)
                self.migrated_pages += full
                self.index_d.insert(h.seq[:full * self.ps], dst)
                self.pool_d.release(MIGRATE_STAGE_SLOT)
            self.pool_p.release(h.slot)
        h.req.log_event("handoff", now)
        self.handoffs_completed += 1
        self.batcher.submit(h.req)
        return True

    def _reroute(self, h: _Handoff, now: int) -> None:
        """Handoff retries exhausted.  Republish what is already computed,
        release the staging reservation, and either re-dispatch through
        another worker (the remount makes the retry cost only the partial
        tail), fall back to decode-side prefill, or -- with fallback
        disabled and reroutes exhausted -- finalize HANDOFF_FAILED."""
        full = h.written // self.ps
        if full > 0:
            self.index_p.insert(h.seq[:full * self.ps], self.pool_p.owned(h.slot))
        self.pool_p.release(h.slot)
        h.req._reroutes = getattr(h.req, "_reroutes", 0) + 1
        self.reroutes += 1
        if h.req._reroutes > self.reroutes_max:
            if self.degraded_fallback:
                h.req.log_event("handoff_fallback_decode", now)
                self.batcher.submit(h.req)
            else:
                h.req.log_event("handoff_failed", now)
                self.batcher._finalize(h.req, FinishReason.HANDOFF_FAILED)
        else:
            h.req.log_event("handoff_reroute", now)
            self.queue.appendleft(h.req)

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def degraded(self) -> bool:
        """Engine-observed: no dispatch-eligible prefill worker remains."""
        return all(w.suspected for w in self.workers)

    def worker_health(self) -> List[dict]:
        return [{
            "wid": w.wid,
            "state": w.state,
            "suspected": w.suspected,
            "busy": w.busy,
            "launches": w.launches,
            "last_beat": w.last_beat,
            "straggler_flags": len(w.detector.flagged),
        } for w in self.workers]

    def summary(self) -> dict:
        return {
            "shared_pool": self.shared_pool,
            "accepted": self.accepted,
            "prefill_launches": self.prefill_launches,
            "handoffs_completed": self.handoffs_completed,
            "handoff_drops": self.handoff_drops,
            "reroutes": self.reroutes,
            "recoveries": self.recoveries,
            "degraded_forwards": self.degraded_forwards,
            "migrated_pages": self.migrated_pages,
            "bypassed": self.bypassed,
            "degraded": self.degraded(),
            "workers": self.worker_health(),
            "batcher": self.batcher.health_summary(),
        }
