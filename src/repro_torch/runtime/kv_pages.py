"""Paged KV-cache page allocator: fixed-size pages over a flat pool.

The serving path's dense cache is a (slots, max_len) rectangle: every decode
step streams the full padded cache and every admission zeroes max_len rows.
This module replaces the rectangle with a pool of fixed-size pages plus
per-slot page tables (the vLLM PagedAttention construction):

  - the physical cache is (num_pages, page_size, ...) arrays owned by the
    model cache pytree;
  - each slot owns an ordered list of page ids covering its live positions;
    logical position p lives at (table[p // page_size], p % page_size);
  - admission reserves ceil(expected_len / page_size) pages from a free
    list — O(pages touched), never O(max_len) — and eviction returns them
    with NO zeroing: stale page contents are dead by construction because
    attention masks positions >= the slot's live length, so a recycled page
    is simply overwritten as its new owner decodes forward.

Page id 0 is a reserved *dump* page that is never allocated: free slots'
page-table rows all point at it, so the batched per-slot cache write
(`models/layers.Attention.decode_paged`) needs no active-slot masking —
inactive lanes harmlessly scribble on the dump page.

Pages are *reference counted* so they can be shared across owners — the
cross-request prefix cache (runtime/prefix_cache) maps a request's common
prompt prefix onto pages some earlier request already prefilled.  A page is
returned to the free list only when its last reference drops (`decref`);
`release(slot)` decrements instead of frees.  A slot that must write into
a page it shares first privatizes it with `cow(slot, idx)` — copy-on-write
at page granularity: one fresh page is allocated, the shared page loses one
reference, and the caller copies the device rows.  This is the serving
analogue of the paper's tile-buffer reuse: operands (here, cached K/V rows)
stay resident and are *referenced* by new consumers instead of being
re-computed and re-streamed per request.

Everything here is host-side numpy/Python (the scheduler's bookkeeping);
the device side consumes only the rendered `page_table()` / `lengths()`
arrays; the CUDA decode kernel (`kernels/mx_flash_decode`) reads each
slot's page ids from the table itself before it computes K/V addresses.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

DUMP_PAGE = 0  # reserved page id: write target for inactive slots


class PoolExhausted(Exception):
    """Raised by strict allocation when the free list cannot cover a
    reservation.  The batcher's admission path uses the non-raising
    `try_reserve` instead — exhaustion back-pressures the queue, it must
    never crash the serving loop."""


@dataclasses.dataclass
class PoolStats:
    num_pages: int          # allocatable pages (excludes the dump page)
    page_size: int
    pages_in_use: int
    pages_free: int
    live_tokens: int
    high_water: int         # max pages_in_use seen since construction
    pages_touched: int = 0  # sum over SERVING slots of ceil(len / page_size)
    pages_shared: int = 0   # pages with refcount > 1 (incl. index pins)
    pages_reused: int = 0   # pages mounted from a prefix hit by live slots
    shared_high_water: int = 0
    # parked reservations (staged disagg handoffs awaiting delivery): their
    # tokens are done-but-in-flight, not live serving state.  Before the
    # park split they were folded into live_tokens/pages_touched, so a
    # handoff that was DROPPED and rerouted counted the same tokens twice
    # over an episode (once under the dead staging id, once under the
    # re-prefilled one) and occupancy mixed serving state with freight.
    tokens_parked: int = 0
    pages_parked: int = 0

    @property
    def utilization(self) -> float:
        """Fraction of the allocatable pool currently reserved."""
        return self.pages_in_use / self.num_pages if self.num_pages else 0.0

    @property
    def occupancy(self) -> float:
        """Live tokens / capacity of the pages the live lengths actually
        touch — internal fragmentation (1.0 = every touched page row holds
        a live token).  The denominator counts the last, partially-filled
        page of every slot (ceil(len / page_size) pages), NOT the full
        reservation: a slot admitted mid-page contributes its partial page
        the moment it has one live token, so occupancy is consistent across
        the token-by-token and chunked prefill paths."""
        cap = self.pages_touched * self.page_size
        return self.live_tokens / cap if cap else 1.0

    @property
    def reserved_headroom(self) -> float:
        """Fraction of reserved pages not yet touched by a live token —
        the admission-time worst-case reservation the slots may still grow
        into (distinct from `occupancy`'s within-page fragmentation)."""
        if not self.pages_in_use:
            return 0.0
        return max(0, self.pages_in_use - self.pages_touched) / self.pages_in_use

    def as_dict(self) -> dict:
        return {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "pages_in_use": self.pages_in_use,
            "pages_free": self.pages_free,
            "live_tokens": self.live_tokens,
            "high_water": self.high_water,
            "pages_touched": self.pages_touched,
            "pages_shared": self.pages_shared,
            "pages_reused": self.pages_reused,
            "shared_high_water": self.shared_high_water,
            "tokens_parked": self.tokens_parked,
            "pages_parked": self.pages_parked,
            "utilization": self.utilization,
            "occupancy": self.occupancy,
            "reserved_headroom": self.reserved_headroom,
        }


class PagePool:
    """Reference-counted free-list page allocator over `num_pages`
    allocatable pages.

    ``total_pages`` (what the physical cache arrays are sized to) is
    ``num_pages + 1``: page 0 is the reserved dump page.  Pages are
    recycled LIFO — the most recently freed pages are reallocated first,
    which keeps the working set of hot pages small.

    A page may be referenced by several owners at once (slots sharing a
    prompt prefix, plus the prefix index pinning it for future requests);
    it returns to the free list only when the count hits zero.  Owners
    never write into a shared page — `cow` privatizes first.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 1:
            raise ValueError(f"need at least 1 allocatable page, got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        # LIFO free list of allocatable ids (1..num_pages); 0 is the dump page
        self._free: List[int] = list(range(self.num_pages, 0, -1))
        self._refs: Dict[int, int] = {}          # page id -> reference count
        self._owned: Dict[int, List[int]] = {}   # slot -> page ids, in order
        self._lengths: Dict[int, int] = {}       # slot -> live token count
        self._mounted: Dict[int, int] = {}       # slot -> pages mounted shared
        self._parked: set = set()                # slots staged for handoff
        self._high_water = 0
        self._shared_high_water = 0

    # ------------------------------------------------------------------
    # allocation / release
    # ------------------------------------------------------------------

    @property
    def total_pages(self) -> int:
        """Physical page count the cache arrays must be sized to."""
        return self.num_pages + 1

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold `tokens` positions."""
        return -(-max(int(tokens), 0) // self.page_size)

    # ---- reference counting ----

    def refcount(self, page: int) -> int:
        """Current reference count (0 = free / never allocated)."""
        return self._refs.get(int(page), 0)

    def incref(self, page: int) -> int:
        """Add a reference to an allocated page; returns the new count.
        Referencing a free page is an error — there is nothing to share."""
        page = int(page)
        if page not in self._refs:
            raise ValueError(f"page {page} is not allocated; cannot incref")
        self._refs[page] += 1
        self._track_sharing()
        return self._refs[page]

    def decref(self, page: int) -> int:
        """Drop a reference; frees the page (back to the LIFO free list, no
        zeroing) when the count reaches zero.  Returns the new count.
        A double-release — decref of a page that is already free — is an
        error: it means two owners both believed they held the last
        reference, and silently honoring it would hand the same physical
        page to two future tenants."""
        page = int(page)
        if page not in self._refs:
            raise ValueError(
                f"page {page} is already free (double release)")
        self._refs[page] -= 1
        if self._refs[page] == 0:
            del self._refs[page]
            self._free.append(page)
            return 0
        return self._refs[page]

    def _alloc_one(self) -> int:
        page = self._free.pop()
        self._refs[page] = 1
        return page

    def _track_sharing(self) -> None:
        self._shared_high_water = max(self._shared_high_water,
                                      self.pages_shared)

    @property
    def pages_shared(self) -> int:
        """Pages currently referenced by more than one owner."""
        return sum(1 for c in self._refs.values() if c > 1)

    def try_reserve(self, slot: int, tokens: int,
                    shared: Optional[List[int]] = None) -> Optional[List[int]]:
        """Reserve pages covering `tokens` positions for `slot`.

        ``shared`` prepends already-resident pages (a prefix-cache hit):
        each gains a reference instead of costing a fresh page, and only
        ceil(tokens/page_size) - len(shared) pages come off the free list.

        Returns the slot's page-id list, or None (and changes NOTHING) when
        the free list cannot cover the fresh tail — the caller
        back-pressures.  A slot must be released before it can be reserved
        again."""
        if slot in self._owned:
            raise ValueError(f"slot {slot} already holds a reservation")
        shared = [int(p) for p in (shared or [])]
        for p in shared:
            if p not in self._refs:
                raise ValueError(f"shared page {p} is not allocated")
        need = self.pages_for(tokens) - len(shared)
        if need > len(self._free):
            return None
        for p in shared:
            self._refs[p] += 1
        pages = shared + [self._alloc_one() for _ in range(max(need, 0))]
        self._owned[slot] = pages
        self._mounted[slot] = len(shared)
        self._lengths[slot] = 0
        self._high_water = max(self._high_water, self.pages_in_use)
        self._track_sharing()
        return list(pages)

    def cow(self, slot: int, idx: int) -> Optional[tuple]:
        """Copy-on-write: privatize the slot's idx-th page before a write.

        If the page is exclusively held (refcount 1) it is returned as-is —
        (page, page), nothing to copy.  Otherwise ONE fresh page is
        allocated, the shared page loses exactly one reference (the other
        sharers keep theirs), and (old, new) is returned so the caller can
        copy the device rows old -> new.  Returns None (state unchanged)
        when the pool cannot supply the fresh page."""
        if slot not in self._owned:
            raise KeyError(f"slot {slot} has no reservation")
        old = self._owned[slot][idx]
        if self._refs[old] == 1:
            return (old, old)
        if not self._free:
            return None
        new = self._alloc_one()
        self._refs[old] -= 1  # never reaches 0: it was > 1
        self._owned[slot][idx] = new
        if idx < self._mounted.get(slot, 0):
            self._mounted[slot] -= 1  # the private copy is no longer reuse
        self._high_water = max(self._high_water, self.pages_in_use)
        return (old, new)

    def reserve(self, slot: int, tokens: int,
                shared: Optional[List[int]] = None) -> List[int]:
        """Strict variant of `try_reserve`: raises PoolExhausted."""
        got = self.try_reserve(slot, tokens, shared)
        if got is None:
            raise PoolExhausted(
                f"need {self.pages_for(tokens) - len(shared or [])} fresh "
                f"pages for slot {slot}, only {len(self._free)} free"
            )
        return got

    def extend(self, slot: int, tokens: int) -> Optional[List[int]]:
        """Grow slot's reservation to cover `tokens` positions (e.g. a
        request outliving its initial estimate).  Returns the new full page
        list, or None (unchanged) if the pool cannot cover the growth."""
        if slot not in self._owned:
            raise KeyError(f"slot {slot} has no reservation")
        need = self.pages_for(tokens) - len(self._owned[slot])
        if need <= 0:
            return list(self._owned[slot])
        if need > len(self._free):
            return None
        self._owned[slot].extend(self._alloc_one() for _ in range(need))
        self._high_water = max(self._high_water, self.pages_in_use)
        return list(self._owned[slot])

    def release(self, slot: int) -> int:
        """Drop the slot's reference on each of its pages; pages whose LAST
        reference this was return to the free list (no zeroing — stale
        contents are masked by length).  Pages still referenced elsewhere
        (prefix-index pins, other slots sharing the prefix) stay resident.
        Returns the page count actually freed."""
        pages = self._owned.pop(slot, None)
        self._lengths.pop(slot, None)
        self._mounted.pop(slot, None)
        self._parked.discard(slot)
        if not pages:
            return 0
        freed = 0
        for p in reversed(pages):  # LIFO: hot pages recycle first
            if self.decref(p) == 0:
                freed += 1
        return freed

    def set_length(self, slot: int, tokens: int) -> None:
        """Record the slot's live token count (for occupancy stats and the
        rendered lengths vector)."""
        if slot not in self._owned:
            raise KeyError(f"slot {slot} has no reservation")
        cap = len(self._owned[slot]) * self.page_size
        if tokens > cap:
            raise ValueError(
                f"slot {slot}: length {tokens} exceeds reserved capacity {cap}"
            )
        self._lengths[slot] = int(tokens)

    def owned(self, slot: int) -> List[int]:
        return list(self._owned.get(slot, ()))

    def transfer(self, src: int, dst: int) -> List[int]:
        """Move a reservation between slot ids — pure metadata, no page
        refcount changes and no device traffic.  This is the disagg
        handoff primitive: a prefill worker parks its finished pages under
        a staging id so its own slot id is immediately reusable, and the
        decode side later mounts the same physical pages.  Parked status
        does NOT travel: the destination starts as an ordinary (serving)
        reservation until `park`ed.  Returns the page list now owned by
        `dst`."""
        if src not in self._owned:
            raise KeyError(f"slot {src} has no reservation")
        if dst in self._owned:
            raise ValueError(f"slot {dst} already holds a reservation")
        self._owned[dst] = self._owned.pop(src)
        self._lengths[dst] = self._lengths.pop(src, 0)
        self._mounted[dst] = self._mounted.pop(src, 0)
        self._parked.discard(src)
        return list(self._owned[dst])

    def park(self, slot: int) -> None:
        """Mark a reservation as PARKED freight — a staged handoff whose
        tokens are computed but not (yet) live serving state.  Parked
        reservations keep their pages/refcounts (delivery is a metadata
        mount) but report under ``tokens_parked``/``pages_parked`` instead
        of ``live_tokens``/``pages_touched``/``pages_reused``.  Without
        this split a dropped-then-rerouted handoff double-counts: the dead
        staging reservation and the re-prefilled copy both report the same
        tokens as live until the drop's release lands.  `release` and
        `transfer` clear the mark."""
        if slot not in self._owned:
            raise KeyError(f"slot {slot} has no reservation")
        self._parked.add(slot)

    def parked(self, slot: int) -> bool:
        return slot in self._parked

    # ------------------------------------------------------------------
    # device-facing views
    # ------------------------------------------------------------------

    def page_table(self, n_slots: int, width: int) -> np.ndarray:
        """(n_slots, width) int32 table; unreserved entries point at the
        dump page, so every entry is a valid physical page id (the decode
        kernel's BlockSpec DMAs the steered page unconditionally and relies
        on the length mask, never on table validity)."""
        table = np.full((n_slots, width), DUMP_PAGE, np.int32)
        for slot, pages in self._owned.items():
            if 0 <= slot < n_slots:
                k = min(len(pages), width)
                table[slot, :k] = pages[:k]
        return table

    def slot_table(self, slot: int, width: int) -> np.ndarray:
        """(1, width) int32 page-table row for ONE slot, valid for any slot
        id (the batched `page_table` view only renders ids in
        [0, n_slots)).  This is what the disagg prefill workers feed
        `prefill_step_paged`: each worker runs batch=1 under a private
        high slot id that never collides with the decode batcher's
        slots."""
        row = np.full((1, width), DUMP_PAGE, np.int32)
        pages = self._owned.get(slot, ())
        k = min(len(pages), width)
        row[0, :k] = pages[:k]
        return row

    def lengths(self, n_slots: int) -> np.ndarray:
        """(n_slots,) int32 live token counts (0 for slots with no
        reservation) — the decode kernel's validity mask."""
        out = np.zeros((n_slots,), np.int32)
        for slot, ln in self._lengths.items():
            if 0 <= slot < n_slots:
                out[slot] = ln
        return out

    def stats(self) -> PoolStats:
        serving = {s: ln for s, ln in self._lengths.items()
                   if s not in self._parked}
        parked = {s: ln for s, ln in self._lengths.items()
                  if s in self._parked}
        return PoolStats(
            num_pages=self.num_pages,
            page_size=self.page_size,
            pages_in_use=self.pages_in_use,
            pages_free=len(self._free),
            live_tokens=sum(serving.values()),
            high_water=self._high_water,
            pages_touched=sum(self.pages_for(ln)
                              for ln in serving.values()),
            pages_shared=self.pages_shared,
            pages_reused=sum(m for s, m in self._mounted.items()
                             if s not in self._parked),
            shared_high_water=self._shared_high_water,
            tokens_parked=sum(parked.values()),
            pages_parked=sum(self.pages_for(ln) for ln in parked.values()),
        )
