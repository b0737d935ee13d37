"""Continuous-batching serving scheduler (port of
`repro/runtime/batcher.py`).

Fixed B decode slots; requests stream in, each slot decodes at its own
position.  Two cache backends:

  - paged (``paged=True``, the port's default): a flat page pool + per-slot
    page tables (runtime/kv_pages): admission reserves
    ceil(expected_tokens/page_size) pages from the free list
    (back-pressuring the queue when the pool is exhausted instead of
    crashing), eviction returns them with NO zeroing, and each decode step
    attends only over pages the live sequences touch.  The device step is
    `model.decode_step_paged` (the CUDA `mx_flash_decode` and
    `mx_matmul_fused` kernels on the card).  ``kv_quant=QuantSpec("int8")``
    (or ``QuantSpec("fp8_e4m3")``) stores the pages as int8 (fp8) with
    per-row f32 scale pages.
  - dense (``paged=False``, JAX's default): the (slots, max_len) rectangle
    of `model.make_cache` (`cache_dtype`), and state blocks' recurrent
    state beside it (Mamba2, mLSTM, sLSTM) -- the backend of state-block,
    shared-block and prefix-embedding models (zamba2, xlstm, internvl2
    served text only).  The device step is `model.decode_step` with a (B,)
    index; a free slot still steps, with token 0 at index 0, as in JAX.
    Admission is immediate, each prompt is stepped token by token, and
    finishing or preempting a slot zeroes its rows of every cache leaf
    (JAX resets a slot there, not at admission; an xLSTM slot's maxima
    become 0, not their initial -1e30, as in JAX).  The prefix cache,
    chunked prefill, speculation and `kv_quant` need the pages and raise
    ValueError without them, as in JAX.

  - ``prefix_cache=True``: a content index over the page pool
    (runtime/prefix_cache) maps each request's longest already-prefilled
    prefix onto resident pages; admission mounts the matched span as
    SHARED (refcounted) pages, copies one page on write at an intra-page
    divergence, and only reserves + prefills the tail.
  - ``prefill_chunk=N``: admission pushes the unmatched tail through
    `model.prefill_step_paged` N tokens per launch, writing K/V directly
    into the slot's pages.  The prompt's LAST token always rides the
    ordinary decode step.

  - ``speculate=k``: decode runs speculative windows.  A ``drafter``
    (runtime/speculative; default NGramDrafter) proposes up to k tokens per
    decoding slot, one `model.verify_step_paged` pass (`mx_flash_verify`
    on the card) scores all k+1 window rows, and the drafts that match the
    verify argmax chain are emitted (greedy-exact: the stream equals
    speculate=0).  Rejected drafts roll back by not advancing the slot's
    length; their rows stay stale in the slot's reserved pages.  Slots
    still prefilling ride the same pass as forced-token windows.

The request lifecycle (runtime/lifecycle) on top: typed finish reasons,
priorities, step deadlines with load shedding, and preemption with
page-backed recompute (a preempted request's full pages are published
into the prefix index, so re-admission recomputes only the unshared tail).

  - ``abft=True``: silent-data-corruption detection end to end.  The
    device step runs under `kernels.abft.use_abft()` (every "cuda_mx" GEMM
    inside it verifies its checksums, with recovery), and token derivation
    reads a host copy of the logits verified against the device array by
    an exact checksum; on a mismatch the copy is fetched again and the
    ``sdc_detected`` / ``sdc_corrected`` counters of `health_summary()`
    advance.  With no corruption the streams are bitwise those of
    ``abft=False``.

  - ``chaos`` (a lifecycle.ChaosInjector) threaded through `step()` and the
    speculative step: an injected transient failure is raised before the
    device call, so the retried step writes the pages exactly once, with
    the values an unfailed step writes; non-finite logits quarantine ONLY
    the poisoned slot ("failed"; the argmax is taken from the device
    logits before the guard's host copy is poisoned, and other slots'
    outputs are untouched); pool pressure (pages seized under slot -99,
    which `page_table` / `lengths` never render) drives the preemption
    path; latency spikes feed the `StragglerDetector` watchdog; bit flips
    corrupt the ABFT audit's host copy.  The non-finite guard is on
    whenever chaos is (``nonfinite_guard=True`` forces it on): a
    device-to-host copy of the last logits every step.
  - ``pool`` / ``prefix_index``: an external `PagePool` (and a
    `PrefixIndex` over it) shared with the disaggregated engine's prefill
    workers (runtime/disagg), so a handoff is pure metadata.
"""
from __future__ import annotations

import time
from collections import Counter, deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from ..kernels.abft import use_abft
from ..models.modules import param_device
from .fault import DeviceFailure, StragglerDetector
from .kv_pages import PagePool
from .lifecycle import (
    ChaosInjector, FinishReason, Request, RequestState, RetryPolicy, StepHealth,
)
from .prefix_cache import PrefixIndex
from .speculative import DraftProposer, NGramDrafter, SpecStats, accept_greedy

__all__ = ["ContinuousBatcher", "Request", "FinishReason"]


class _Slot:
    def __init__(self):
        self.req: Optional[Request] = None
        self.pos = 0           # next cache position to write
        self.prompt_left = 0   # tokens of seq still to feed
        self.seq: Optional[np.ndarray] = None  # prompt + prior output
        self.admit_order = 0   # preemption tie-break: newest victim first

    @property
    def free(self) -> bool:
        return self.req is None


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


class ContinuousBatcher:
    """model: DecoderLM; params: its parameters (the batcher runs on their
    device); B slots; max_len tokens per slot.  ``paged`` picks the cache
    backend; ``page_size`` tokens per page, ``num_pages`` allocatable pages
    (default: every slot at max_len).  ``cache_dtype`` is the K/V dtype of
    either backend.  ``kv_quant``, ``prefix_cache`` (``prefix_max_pinned``
    caps the pages its index may pin), ``prefill_chunk``, ``speculate``,
    ``drafter``, ``pool`` and ``prefix_index`` (paged only), ``chaos``,
    ``nonfinite_guard`` and ``abft`` as in the module docstring."""

    def __init__(self, model, params, batch_slots: int, max_len: int,
                 cache_dtype=torch.float32, *, paged: bool = True,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 kv_quant=None, prefix_cache: bool = False,
                 prefill_chunk: int = 0,
                 prefix_max_pinned: Optional[int] = None,
                 pool: Optional[PagePool] = None,
                 prefix_index: Optional[PrefixIndex] = None,
                 chaos: Optional[ChaosInjector] = None,
                 retry: Optional[RetryPolicy] = None,
                 nonfinite_guard: Optional[bool] = None,
                 straggler: Optional[StragglerDetector] = None,
                 speculate: int = 0, drafter: Optional[DraftProposer] = None,
                 abft: bool = False):
        if (prefix_cache or prefill_chunk) and not paged:
            raise ValueError("prefix_cache / prefill_chunk require "
                             "paged=True (they operate on the page pool)")
        if (pool is not None or prefix_index is not None) and not paged:
            raise ValueError("an external pool / prefix_index requires "
                             "paged=True")
        if speculate and not paged:
            raise ValueError("speculate requires paged=True (the verify "
                             "window writes through the page tables)")
        if speculate < 0:
            raise ValueError(f"speculate must be >= 0, got {speculate}")
        if prefix_index is not None and (pool is None or prefix_index.pool is not pool):
            raise ValueError("prefix_index must be built over the "
                             "external pool it is passed with")
        if kv_quant is not None and not paged:
            raise ValueError("kv_quant requires paged=True (the dense "
                             "cache dtype is `cache_dtype`)")
        if paged and not model.supports_paged():
            raise ValueError("model does not support paged decode (needs attention-"
                             "only segments; state/shared-block archs use dense)")
        self.model = model
        self.paged = paged
        self.params = params
        self.device = param_device(params)
        self.B = batch_slots
        self.max_len = max_len
        self.slots = [_Slot() for _ in range(batch_slots)]
        self.queue: Deque[Request] = deque()
        self.finished: Dict[int, Request] = {}
        self.prefix: Optional[PrefixIndex] = None
        self.prefill_chunk = int(prefill_chunk)
        self.cow_copies = 0
        self.prefill_launches = 0  # chunked prefill launches issued

        # lifecycle / fault state
        self.chaos = chaos
        self.retry = retry or RetryPolicy()
        self.guard = bool(nonfinite_guard) if nonfinite_guard is not None \
            else chaos is not None
        self.watchdog = straggler or StragglerDetector()
        self.steps_run = 0
        self.health: Deque[StepHealth] = deque(maxlen=4096)
        self.preemptions_total = 0
        self.resumes_total = 0
        self.resume_latencies: List[int] = []  # steps preempted -> readmitted
        self.retries_total = 0
        self._submit_order = 0

        # speculative decoding state
        self.speculate = int(speculate)
        self.drafter = (drafter or NGramDrafter()) if self.speculate else None
        self.spec = SpecStats()

        # ABFT (SDC detection) state
        self.abft = bool(abft)
        self.sdc_detected = 0
        self.sdc_corrected = 0

        if not paged:
            self.pool = None
            self.cache = model.make_cache(batch_slots, max_len, dtype=cache_dtype,
                                          device=self.device)
            return
        # an external pool (disagg: prefill workers and the decode batcher
        # share one allocator) dictates page_size and capacity
        self.page_size = pool.page_size if pool is not None else page_size
        self._table_width = -(-max_len // self.page_size)
        self.pool = pool if pool is not None else PagePool(
            num_pages if num_pages is not None else batch_slots * self._table_width,
            self.page_size)
        self.cache = model.make_paged_cache(
            self.pool.total_pages, self.page_size, dtype=cache_dtype,
            device=self.device, kv_quant=kv_quant)
        if prefix_index is not None:
            self.prefix = prefix_index
        elif prefix_cache:
            self.prefix = PrefixIndex(self.pool, max_pinned_pages=prefix_max_pinned)

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr, device=self.device)

    def _copy_page(self, src: int, dst: int) -> None:
        """COW privatization, IN PLACE: one page's rows for every layer and
        operand (cache leaves are layer-stacked, the page axis is 1)."""
        for seg in self.cache.values():
            for t in seg.values():
                t[:, dst].copy_(t[:, src])

    # ------------------------------------------------------------------
    # lifecycle entry points
    # ------------------------------------------------------------------

    def submit(self, req: Request):
        if req.submitted_at < 0:
            req.submitted_at = self.steps_run
        req.state = RequestState.QUEUED
        req.log_event("submitted", self.steps_run)
        req._order = self._submit_order  # FIFO tie-break within a priority
        self._submit_order += 1
        self.queue.append(req)

    def cancel(self, rid: int) -> bool:
        """Cancel a queued or running request ("cancelled"); returns False
        when the rid is unknown or already finished."""
        for req in self.queue:
            if req.rid == rid:
                self.queue.remove(req)
                self._finalize(req, FinishReason.CANCELLED)
                return True
        for i, s in enumerate(self.slots):
            if not s.free and s.req.rid == rid:
                self._finish_slot(i, FinishReason.CANCELLED)
                return True
        return False

    def preempt(self, rid: int) -> bool:
        """Preempt a running request: publish its full pages into the
        prefix index, release the slot, and requeue it with its generated
        tokens retained.  Returns False when the rid is not running."""
        for i, s in enumerate(self.slots):
            if not s.free and s.req.rid == rid:
                self._preempt_slot(i)
                return True
        return False

    # ------------------------------------------------------------------
    # admission / preemption
    # ------------------------------------------------------------------

    HIT_SCAN_LIMIT = 64  # hit-aware admission: queue prefix scanned (FIFO)

    def _pick_next(self) -> Optional[Request]:
        """Highest priority first; within it, the queued request with the
        longest resident-prefix match (read-only peeks), FIFO on ties."""
        if not self.queue:
            return None
        best = min(self.queue,
                   key=lambda r: (-r.priority, getattr(r, "_order", 0)))
        if self.prefix is None or not self.prefix.entries:
            return best
        cands = sorted((r for r in self.queue if r.priority == best.priority),
                       key=lambda r: getattr(r, "_order", 0))
        cands = cands[:self.HIT_SCAN_LIMIT]
        return max(cands, key=lambda r: (
            self.prefix.lookup(r.sequence(), peek=True).matched_tokens,
            -getattr(r, "_order", 0)))

    def _pick_victim(self, min_priority: int) -> Optional[int]:
        """The strictly-lower-priority active slot with the lowest
        priority; ties break to the most recently admitted."""
        best, best_key = None, None
        for i, s in enumerate(self.slots):
            if s.free or s.req.priority >= min_priority:
                continue
            key = (s.req.priority, -s.admit_order)
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best

    def _estimate_steps(self, req: Request) -> int:
        """Optimistic steps-to-finish if admitted now, assuming no prefix hit."""
        prefill = 1 if self.prefill_chunk > 0 else max(len(req.sequence()), 1)
        return prefill - 1 + req.remaining_new()

    def _expire_queued(self, health: StepHealth):
        now = self.steps_run
        for req in list(self.queue):
            waited = now - req.submitted_at
            if ((req.deadline_steps is not None
                 and waited >= req.deadline_steps)
                    or (req.ttft_steps is not None and not req.output
                        and waited >= req.ttft_steps)):
                self.queue.remove(req)
                req.log_event("expired", now)
                self._finalize(req, FinishReason.DEADLINE)
                health.shed.append(req.rid)

    def _shed_hopeless(self, health: StepHealth):
        """Shed requests still queued after this step's admissions whose
        wait plus an optimistic estimate already overruns the deadline."""
        now = self.steps_run
        for req in list(self.queue):
            waited = now - req.submitted_at
            if ((req.deadline_steps is not None
                 and waited + self._estimate_steps(req) > req.deadline_steps)
                    or (req.ttft_steps is not None and not req.output
                        and waited + self._estimate_steps(req)
                        - req.remaining_new() + 1 > req.ttft_steps)):
                self.queue.remove(req)
                req.log_event("shed", now)
                self._finalize(req, FinishReason.DEADLINE)
                health.shed.append(req.rid)

    def _expire_running(self, health: StepHealth):
        now = self.steps_run
        for i, s in enumerate(self.slots):
            if s.free:
                continue
            req = s.req
            waited = now - req.submitted_at
            if ((req.deadline_steps is not None
                 and waited >= req.deadline_steps)
                    or (req.ttft_steps is not None and not req.output
                        and waited >= req.ttft_steps)):
                req.log_event("expired", now)
                self._finish_slot(i, FinishReason.DEADLINE)
                health.shed.append(req.rid)

    def _admit(self, health: StepHealth):
        self._expire_queued(health)
        try:
            self._fill_slots(health)
        finally:
            self._shed_hopeless(health)

    def _fill_slots(self, health: StepHealth):
        while self.queue:
            idx = next((i for i, s in enumerate(self.slots) if s.free), None)
            if idx is None:
                return
            req = self._pick_next()
            if not self.paged:
                self.queue.remove(req)
                s = self.slots[idx]
                s.req = req
                s.seq = req.sequence()
                s.pos = 0
                s.prompt_left = len(s.seq)
                self._mark_admitted(s, req)
                continue
            if not self._admit_paged(idx, self.slots[idx], req):
                # pool exhausted: preempt strictly-lower-priority slots
                # until the reservation fits or no victim remains
                admitted = False
                while not admitted:
                    victim = self._pick_victim(req.priority)
                    if victim is None:
                        break
                    health.preempted.append(self.slots[victim].req.rid)
                    self._preempt_slot(victim)
                    admitted = self._admit_paged(idx, self.slots[idx], req)
                if not admitted:
                    return  # back-pressure: req stays queued, FIFO kept
            self.queue.remove(req)

    def _mark_admitted(self, s: _Slot, req: Request):
        now = self.steps_run
        s.admit_order = self._submit_order
        self._submit_order += 1
        req.state = RequestState.PREFILL
        if req.preemptions:
            req.log_event("resumed", now)
            self.resumes_total += 1
            for kind, at in reversed(req.events):
                if kind == "preempted":
                    self.resume_latencies.append(now - at)
                    break
        else:
            req.log_event("admitted", now)

    def _admit_paged(self, i: int, s: _Slot, req: Request) -> bool:
        """Paged admission, O(pages touched): reserves the request's
        worst-case remaining footprint up front; with the prefix cache the
        longest already-prefilled prefix mounts as shared pages (plus at
        most one copy-on-write page) and only the tail costs fresh pages
        and prefill.  Returns False (nothing changed) when the pool cannot
        cover the fresh pages even after index eviction."""
        seq = req.sequence()
        slen = len(seq)
        tokens = min(self.max_len, slen + req.remaining_new())
        shared: list = []
        partial_page, partial_m = None, 0
        # an over-long prompt (truncation path) skips sharing
        if self.prefix is not None and slen + req.remaining_new() <= self.max_len:
            hit = self.prefix.lookup(seq)
            shared = list(hit.pages)
            partial_page, partial_m = hit.partial_page, hit.partial_tokens
        # two plans: with the COW page (one extra fresh page), then without
        for use_partial in ((True, False) if partial_m else (False,)):
            plan = shared + ([partial_page] if use_partial else [])
            need_fresh = (self.pool.pages_for(tokens) - len(plan)
                          + (1 if use_partial else 0))
            short = need_fresh - self.pool.pages_free
            if short > 0 and self.prefix is not None:
                # LRU; never the plan's own hit pages
                self.prefix.evict(short, exclude=plan)
            if need_fresh > self.pool.pages_free:
                continue
            if self.pool.try_reserve(i, tokens, shared=plan) is None:
                continue
            if use_partial:
                src, dst = self.pool.cow(i, len(shared))
                self._copy_page(src, dst)
                self.cow_copies += 1
            matched = len(shared) * self.page_size + (partial_m if use_partial else 0)
            if self.prefix is not None:
                self.prefix.note(matched)
            s.req = req
            s.seq = seq
            s.pos = matched          # next cache position to write
            s.prompt_left = slen - matched
            if matched:
                self.pool.set_length(i, matched)
            self._mark_admitted(s, req)
            if self.prefill_chunk > 0:
                self._prefill_tail(i, s)
            return True
        return False

    def _prefill_tail(self, i: int, s: _Slot):
        """Chunked prefill directly into the slot's pages: positions
        [s.pos, len(seq)-1) go through `prefill_step_paged`, prefill_chunk
        tokens per launch.  The last token is left to the decode step."""
        cap = len(self.pool.owned(i)) * self.page_size
        end = min(len(s.seq) - 1, cap - 1)
        if s.pos >= end:
            return
        table = self._dev(self.pool.page_table(self.B, self._table_width)[i:i + 1])
        while s.pos < end:
            c = min(self.prefill_chunk, end - s.pos)
            toks = self._dev(s.seq[s.pos:s.pos + c][None, :].astype(np.int64))
            self.model.prefill_step_paged(
                self.params, toks, self.cache,
                self._dev(np.asarray([s.pos], np.int64)), table)
            s.pos += c
            s.prompt_left -= c
            self.prefill_launches += 1
            self.pool.set_length(i, s.pos)

    def _preempt_slot(self, i: int):
        """Preemption with page-backed recompute: the slot's FULL pages are
        published into the prefix index before release, so re-admission
        mounts them shared and recomputes only the unshared tail."""
        s = self.slots[i]
        req = s.req
        now = self.steps_run
        if self.paged:
            written = s.pos  # rows actually resident (seq[:written])
            if self.prefix is not None and written >= self.page_size:
                self.prefix.insert(s.seq[:written], self.pool.owned(i))
            self.pool.release(i)
        else:
            self._reset_slot_cache(i)
        req.preemptions += 1
        req.state = RequestState.QUEUED
        req.log_event("preempted", now)
        self.preemptions_total += 1
        s.req = None
        s.seq = None
        s.pos = 0
        s.prompt_left = 0
        self.queue.append(req)  # _order is kept: re-enters ahead of peers

    # ------------------------------------------------------------------
    # termination
    # ------------------------------------------------------------------

    def _finalize(self, req: Request, reason: str):
        assert reason in FinishReason.ALL, reason
        req.finish_reason = reason
        req.state = RequestState.FINISHED
        req.finished_at = self.steps_run
        req.log_event(f"finished:{reason}", self.steps_run)
        self.finished[req.rid] = req

    def _finish_slot(self, i: int, reason: str):
        s = self.slots[i]
        self._finalize(s.req, reason)
        s.req = None
        s.seq = None
        if self.paged:
            self.pool.release(i)  # O(1); no zeroing
        else:
            self._reset_slot_cache(i)

    def _reset_slot_cache(self, i: int):
        """Dense backend: zero slot i's rows of every cache leaf, IN PLACE --
        the O(max_len) write the paged backend replaces with a free-list
        release.  Every leaf is stacked (n, B, ...), so the slot axis is 1."""
        for seg in self.cache.values():
            for t in seg.values():
                t[:, i].zero_()

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    @property
    def active(self) -> int:
        return sum(0 if s.free else 1 for s in self.slots)

    def pool_stats(self):
        """The paged backend's allocator stats (None on the dense backend)."""
        return self.pool.stats() if self.pool is not None else None

    def spec_stats(self) -> Optional[dict]:
        """Acceptance accounting of the verify launches (None when
        speculate=0)."""
        return self.spec.as_dict() if self.speculate else None

    def prefix_stats(self) -> Optional[dict]:
        """Prefix-cache hit/reuse counters (None when prefix_cache off)."""
        if self.prefix is None:
            return None
        st = self.pool.stats()
        out = self.prefix.stats()
        out.update({
            "cow_copies": self.cow_copies,
            "pages_shared": st.pages_shared,
            "pages_reused": st.pages_reused,
            "shared_high_water": st.shared_high_water,
        })
        return out

    def health_summary(self) -> dict:
        reasons = Counter(r.finish_reason for r in self.finished.values())
        return {
            "steps": self.steps_run,
            "retries": self.retries_total,
            "preemptions": self.preemptions_total,
            "resumes": self.resumes_total,
            "resume_latency_steps_mean": (
                float(np.mean(self.resume_latencies))
                if self.resume_latencies else 0.0),
            "quarantined": sum(1 for r in self.finished.values()
                               if r.finish_reason == FinishReason.FAILED),
            "shed_or_expired": sum(1 for r in self.finished.values()
                                   if r.finish_reason == FinishReason.DEADLINE),
            "stragglers": len(self.watchdog.flagged),
            "finish_reasons": dict(reasons),
            "chaos": self.chaos.summary() if self.chaos else None,
            "abft": ({"sdc_detected": self.sdc_detected,
                      "sdc_corrected": self.sdc_corrected} if self.abft else None),
        }

    def _active_width(self) -> int:
        """Page-table width covering the deepest live slot, bucketed to the
        next power of two (entries past a slot's pages are the dump page)."""
        deepest = max((s.pos + 1 for s in self.slots if not s.free), default=1)
        return min(_next_pow2(self.pool.pages_for(deepest)), self._table_width)

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------

    def _device_step(self, args, fail_first: bool, fn=None):
        """One device step (`fn`, the decode step unless given) under the
        retry policy: a DeviceFailure is transient and the step is retried
        from unchanged inputs.  The step writes the pages in place, so an
        injected failure (``fail_first``) is raised BEFORE the device call,
        as in JAX: the failed attempt writes nothing, and the retry leaves
        the pages bitwise those of an unfailed step."""
        if fn is None:
            fn = self.model.decode_step_paged if self.paged else self.model.decode_step
        attempts = 0
        while True:
            try:
                if fail_first and attempts == 0:
                    raise self.chaos.make_failure(self.steps_run)
                if self.abft:  # every "cuda_mx" GEMM of the step checksummed
                    with use_abft():
                        return fn(*args), attempts
                return fn(*args), attempts
            except DeviceFailure:
                attempts += 1
                self.retries_total += 1
                if attempts > self.retry.max_retries:
                    raise
                if self.retry.backoff_s:
                    time.sleep(self.retry.delay(attempts))

    @staticmethod
    def _logit_checksum(t: torch.Tensor) -> torch.Tensor:
        """Per-row checksum over the vocab axis: the f32 bit patterns read as
        int32 and summed in int64 -- exact and independent of the order, so
        the device array and its host copy give the same value bit for bit
        wherever it is taken (JAX takes one jnp reduction on one device; a
        float sum on the card and one on the CPU can differ)."""
        return t.float().contiguous().view(torch.int32).to(torch.int64).sum(-1)

    @staticmethod
    def _to_host(t: torch.Tensor) -> torch.Tensor:
        """The host copy of device logits that token derivation reads."""
        return t.detach().to("cpu", copy=True)

    def _abft_host_logits(self, device_logits: torch.Tensor) -> torch.Tensor:
        """The host copy of the logits, verified against the device array by
        an exact checksum.  The chaos bit-flip stream corrupts the copy in
        flight (the host-side SDC surrogate); on a mismatch it is fetched
        again (recovery is a re-transfer, bitwise the fault-free copy) and
        the SDC counters advance."""
        host = self._to_host(device_logits)
        if self.chaos is not None:
            flip = self.chaos.bitflip(self.steps_run, tuple(host.shape))
            if flip is not None:
                host[flip[0]] += flip[1]
        want = self._logit_checksum(device_logits).cpu()
        bad = self._logit_checksum(host) != want
        if bool(bad.any()):
            n = int(bad.sum())
            self.sdc_detected += n
            host = self._to_host(device_logits)
            if bool((self._logit_checksum(host) == want).all()):
                self.sdc_corrected += n
        return host

    def _guard_finite(self, device_logits: torch.Tensor) -> Optional[np.ndarray]:
        """The non-finite guard (None when off): a host copy of the logits,
        with the chaos victim's row poisoned (the fault the guard must
        catch), reduced to one finite flag per row."""
        if not self.guard:
            return None
        host = self._to_host(device_logits)  # a copy: poisoning writes into it
        if self.chaos is not None:
            victim = self.chaos.poison_slot(
                self.steps_run, [i for i, s in enumerate(self.slots) if not s.free])
            if victim is not None:
                host[victim] = float("nan")
        return torch.isfinite(host).all(dim=-1).numpy()

    def _quarantine(self, i: int, health: StepHealth) -> None:
        """Only slot i fails: its pages are released and nothing it produced
        this step is kept or published."""
        req = self.slots[i].req
        health.poisoned.append(req.rid)
        req.log_event("quarantined", health.step)
        self._finish_slot(i, FinishReason.FAILED)

    def step(self) -> int:
        """One batched decode step across all slots; returns #active slots."""
        if self.speculate:
            return self._step_speculative()
        now = self.steps_run
        health = StepHealth(step=now)
        t0 = time.perf_counter()
        if self.chaos is not None:
            self.chaos.begin_step(now, self.pool)
        self._expire_running(health)
        self._admit(health)
        health.active = self.active
        health.queued = len(self.queue)
        if self.pool is not None:
            health.pages_free = self.pool.pages_free
        if self.active == 0:
            self._flush_health(health, t0, ran_device_step=False)
            return 0
        tokens = np.zeros((self.B, 1), np.int64)
        index = np.zeros((self.B,), np.int64)
        for i, s in enumerate(self.slots):
            if s.free:
                continue
            req = s.req
            if s.prompt_left > 0:  # prefill phase: feed the next seq token
                tokens[i, 0] = s.seq[len(s.seq) - s.prompt_left]
            else:  # decode phase: feed the last generated token
                tokens[i, 0] = req.output[-1]
            index[i] = s.pos
        fail = self.chaos.wants_failure(now) if self.chaos else False
        if self.paged:
            for i, s in enumerate(self.slots):
                if not s.free:
                    self.pool.set_length(i, s.pos + 1)
            table = self._dev(self.pool.page_table(self.B, self._active_width()))
            lengths = self._dev(self.pool.lengths(self.B))
            args = (self.params, self._dev(tokens), self.cache, self._dev(index),
                    table, lengths)
        else:  # free slots step token 0 at index 0, as in JAX
            args = (self.params, self._dev(tokens), self.cache, self._dev(index))
        (logits, self.cache), health.retries = self._device_step(args, fail)
        # torch.argmax, like jnp.argmax, takes the first maximal index; with
        # ABFT it reads the verified host copy
        last = self._abft_host_logits(logits[:, -1]) if self.abft else logits[:, -1]
        next_tok = last.argmax(dim=-1).cpu().numpy().astype(np.int32)
        finite = self._guard_finite(logits[:, -1])
        for i, s in enumerate(self.slots):
            if s.free:
                continue
            req = s.req
            s.pos += 1
            if finite is not None and not finite[i]:
                self._quarantine(i, health)
                continue
            # a slot that exhausted its page reservation (an over-long
            # prompt) is truncated and evicted; the dense rectangle's cap is
            # max_len, below
            out_of_room = self.paged and s.pos >= len(self.pool.owned(i)) * self.page_size
            if s.prompt_left > 1:
                s.prompt_left -= 1  # still prefilling; ignore the logit
                if out_of_room:
                    self._finish_slot(i, FinishReason.TRUNCATED)
                continue
            if s.prompt_left == 1:
                s.prompt_left = 0  # prompt done: this logit starts decode
                req.state = RequestState.DECODE
                if self.prefix is not None and not out_of_room:
                    # the sequence's full pages are now immutable: publish
                    self.prefix.insert(s.seq, self.pool.owned(i))
            req.output.append(int(next_tok[i]))
            if req.first_token_at is None:
                req.first_token_at = now
                req.log_event("first_token", now)
            hit_eos = req.eos_id is not None and req.output[-1] == req.eos_id
            if hit_eos:
                self._finish_slot(i, FinishReason.EOS)
            elif len(req.output) >= req.max_new:
                self._finish_slot(i, FinishReason.MAX_NEW)
            elif s.pos >= self.max_len:
                self._finish_slot(i, FinishReason.MAX_LEN)
            elif out_of_room:
                self._finish_slot(i, FinishReason.TRUNCATED)
        self._flush_health(health, t0, ran_device_step=True)
        return self.active

    def _step_speculative(self) -> int:
        """One speculative verify step across all slots: a (B, k+1) token
        window through `verify_step_paged` in one pass, then host-side
        greedy-exact acceptance.

        Window layout per active slot (S = speculate+1 rows, padded with
        zeros -- pad rows write into future positions of the slot's own
        reserved pages or the dump page, both dead under the length mask):

          - still prefilling: the next up-to-S prompt tokens, forced
            (accepted by construction).  If the window reaches the LAST
            prompt row, up to k drafts ride behind it.
          - decoding: row 0 is the committed last output token, rows 1..k
            the drafter's proposals.

        Acceptance publishes by advancing s.pos and the pool length over
        rows whose fed token is committed; a rejected draft's K/V rows are
        never published.  Every finish path, the prefix-cache publish point,
        the non-finite quarantine and the retry policy mirror the plain step,
        so the emitted argmax stream equals speculate=0."""
        now = self.steps_run
        health = StepHealth(step=now)
        t0 = time.perf_counter()
        if self.chaos is not None:
            self.chaos.begin_step(now, self.pool)
        self._expire_running(health)
        self._admit(health)
        health.active = self.active
        health.queued = len(self.queue)
        health.pages_free = self.pool.pages_free
        if self.active == 0:
            self._flush_health(health, t0, ran_device_step=False)
            return 0
        S = self.speculate + 1
        tokens = np.zeros((self.B, S), np.int64)
        index = np.zeros((self.B,), np.int64)
        lengths = np.zeros((self.B,), np.int32)
        meta = {}
        for i, s in enumerate(self.slots):
            if s.free:
                continue
            req = s.req
            cap = len(self.pool.owned(i)) * self.page_size
            was_prefill = s.prompt_left > 0
            if was_prefill:
                start = len(s.seq) - s.prompt_left
                take = min(S, s.prompt_left, cap - s.pos)
                tokens[i, :take] = s.seq[start:start + take]
                completes = take == s.prompt_left
            else:
                take = 1
                tokens[i, 0] = req.output[-1]
                completes = True
            kd = 0
            drafts = ()
            if completes:
                # drafts stay inside the reservation, max_len and the
                # max_new budget: every finish path lands on the same token
                # as without speculation
                kd = max(0, min(S - take,
                                min(cap, self.max_len) - s.pos - take,
                                req.remaining_new() - 1))
                if kd > 0:
                    prop = np.asarray(self.drafter.propose(req.sequence(), kd),
                                      np.int32).reshape(-1)[:kd]
                    kd = int(prop.size)
                    if kd:
                        tokens[i, take:take + kd] = prop
                    drafts = tuple(int(t) for t in prop)
            index[i] = s.pos
            # the kernel's row-r mask is kpos <= lengths-S+r: pos+S makes
            # row r attend exactly through its own position
            lengths[i] = s.pos + S
            meta[i] = (take, kd, drafts, completes, was_prefill, cap)
        fail = self.chaos.wants_failure(now) if self.chaos else False
        deepest = max(s.pos for s in self.slots if not s.free)
        # window rows reach position pos+S-1, so the table covers one window
        # past the deepest slot, NOT capped at max_len's width like the
        # plain step's (entries past a slot's pages are the dump page, where
        # pad-row writes land harmlessly)
        w = _next_pow2(self.pool.pages_for(deepest + S))
        table = self._dev(self.pool.page_table(self.B, w))
        (logits, self.cache), health.retries = self._device_step(
            (self.params, self._dev(tokens), self.cache, self._dev(index), table,
             self._dev(lengths)), fail, fn=self.model.verify_step_paged)
        self.spec.launches += 1
        win = self._abft_host_logits(logits) if self.abft else logits
        rows = win.argmax(dim=-1).cpu().numpy().astype(np.int32)  # (B, S)
        finite = self._guard_finite(logits)  # (B, S)
        for i, s in enumerate(self.slots):
            if s.free:
                continue
            req = s.req
            take, kd, drafts, completes, was_prefill, cap = meta[i]
            if finite is not None and not finite[i, :take + kd].all():
                self._quarantine(i, health)
                continue
            pos0 = s.pos
            emitted: List[int] = []
            a = 0  # drafts the model agreed with (before EOS truncation)
            if completes:
                emitted, a = accept_greedy(drafts, rows[i, take - 1:take + kd])
            hit_eos = False
            if req.eos_id is not None:
                for j, t in enumerate(emitted):
                    if t == req.eos_id:
                        emitted = emitted[:j + 1]
                        hit_eos = True
                        break
            a_kept = max(len(emitted) - 1, 0)
            s.pos = pos0 + take + a_kept
            if was_prefill:
                s.prompt_left -= take
            self.pool.set_length(i, s.pos)
            if kd > 0:
                self.spec.windows += 1
                self.spec.drafted += kd
                self.spec.accepted += a
                req.log_event(f"speculated:{a}/{kd}", now)
            self.spec.emitted += len(emitted)
            out_of_room = s.pos >= cap
            if not completes:
                if out_of_room:
                    self._finish_slot(i, FinishReason.TRUNCATED)
                continue
            if was_prefill:
                req.state = RequestState.DECODE
                # the plain path's publish condition, at the position the
                # LAST PROMPT row landed
                if self.prefix is not None and pos0 + take < cap:
                    self.prefix.insert(s.seq, self.pool.owned(i))
            req.output.extend(emitted)
            if req.first_token_at is None:
                req.first_token_at = now
                req.log_event("first_token", now)
            if hit_eos:
                self._finish_slot(i, FinishReason.EOS)
            elif len(req.output) >= req.max_new:
                self._finish_slot(i, FinishReason.MAX_NEW)
            elif s.pos >= self.max_len:
                self._finish_slot(i, FinishReason.MAX_LEN)
            elif out_of_room:
                self._finish_slot(i, FinishReason.TRUNCATED)
        self._flush_health(health, t0, ran_device_step=True)
        return self.active

    def _flush_health(self, health: StepHealth, t0: float, ran_device_step: bool):
        health.dt_s = time.perf_counter() - t0
        if self.chaos is not None:
            health.dt_s += self.chaos.latency_spike(health.step)
        if ran_device_step:
            health.straggler = self.watchdog.observe(health.step, health.dt_s)
        self.health.append(health)
        self.steps_run += 1

    def run_to_completion(self, max_steps: int = 10_000) -> Dict[int, Request]:
        """Drain the queue.  Hitting max_steps is an overload deadline:
        still-running and still-queued requests finish "deadline" (or
        "preempted_requeued"), so every request gets a typed reason."""
        steps = 0
        while (self.queue or self.active) and steps < max_steps:
            self.step()
            steps += 1
        if self.queue or self.active:
            for i, s in enumerate(self.slots):
                if not s.free:
                    self._finish_slot(i, FinishReason.DEADLINE)
            while self.queue:
                req = self.queue.popleft()
                self._finalize(
                    req,
                    FinishReason.PREEMPTED_REQUEUED if req.preemptions
                    else FinishReason.DEADLINE)
        if self.chaos is not None:
            self.chaos.end(self.pool)
        return self.finished
