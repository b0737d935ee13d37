"""Cross-request prompt-prefix index over the KV page pool.

N requests sharing a system prompt should not each burn pages and re-run
identical prefill GEMMs.  This index maps *content* — token-id chunks at
page granularity — to physical pages some earlier request already
prefilled, so `ContinuousBatcher` admission can mount the common prefix as
shared (reference-counted) pages and only reserve + prefill the tail.
The paper's tile-buffer argument at the cache level: keep operands resident
and add references instead of re-streaming/re-computing them.

Structure: a trie keyed by page-sized token chunks.  Each node is one full
page of prompt tokens; its path from the root spells the prefix, so two
prompts share exactly the nodes their token ids agree on.  No hashing
ambiguity: nodes compare the actual chunk tuples (a chain hash would need
collision verification anyway; the dict-of-tuples IS that verification).

Only FULL pages are indexed — a page is immutable once its owner's prompt
has filled it (decode continues in later pages), which is what makes
sharing safe without synchronization.  A request whose prefix diverges
*inside* a page can still reuse the matched rows: `lookup` reports the
best partially-matching child, and the batcher mounts it copy-on-write
(`PagePool.cow`) — copy once, then overwrite rows from the divergence
point.

Index entries PIN their pages (one pool reference) so releasing the
original request does not free them.  Under pool pressure `evict` drops
least-recently-used leaf entries whose page nobody else references; a page
some live slot still shares (refcount > 1) is never freed by eviction.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .kv_pages import PagePool


@dataclasses.dataclass
class _Node:
    """One indexed full page: `chunk` (page_size token ids) under `parent`."""
    chunk: Tuple[int, ...]
    page: int
    parent: Optional["_Node"]
    children: Dict[Tuple[int, ...], "_Node"] = dataclasses.field(
        default_factory=dict)
    last_used: int = 0


@dataclasses.dataclass
class PrefixHit:
    """Admission-time lookup result.

    ``pages``: full pages covering ``len(pages) * page_size`` prompt tokens,
    to be mounted shared (each gains a pool reference).
    ``partial_page`` / ``partial_tokens``: a page whose first
    ``partial_tokens`` rows match the next prompt tokens — mount via COW.
    ``matched_tokens``: total prompt tokens whose prefill is skipped.
    """
    pages: List[int]
    partial_page: Optional[int]
    partial_tokens: int

    @property
    def matched_tokens(self) -> int:
        return len(self.pages) * self._page_size + self.partial_tokens

    _page_size: int = 0  # set by the index; tokens per page


class PrefixIndex:
    """Token-chunk trie -> physical page ids, with LRU eviction."""

    def __init__(self, pool: PagePool,
                 max_pinned_pages: Optional[int] = None):
        self.pool = pool
        self.page_size = pool.page_size
        # budget cap on index pins: a hot index can otherwise pin the pool
        # into admission starvation (every entry holds one page reference).
        # None = uncapped (bounded only by `evict` under pool pressure).
        self.max_pinned_pages = max_pinned_pages
        self._roots: Dict[Tuple[int, ...], _Node] = {}
        self._tick = 0
        # counters (serve/bench reporting)
        self.hits = 0           # admissions that reused >= 1 page
        self.misses = 0
        self.tokens_saved = 0   # prompt tokens whose prefill was skipped
        self.entries = 0
        self.evicted_pages = 0

    # ------------------------------------------------------------------

    def _chunks(self, prompt: Sequence[int]) -> List[Tuple[int, ...]]:
        ps = self.page_size
        n_full = len(prompt) // ps
        return [tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])
                for i in range(n_full)]

    def lookup(self, prompt: Sequence[int], peek: bool = False) -> PrefixHit:
        """Longest indexed prefix of `prompt`, at page granularity.

        Full-page matching is capped at floor((len-1)/page_size) pages and
        the partial match at the remaining length minus one: at least the
        prompt's LAST token always runs through the decode step, which is
        what produces the first generation logits (and keeps the shared
        path launch-for-launch identical to the unshared one from there).

        ``peek=True`` is a read-only probe: no LRU clock advance and no
        `last_used` touches.  Hit-aware admission ordering scans the whole
        queue with peeks; only the request actually admitted should renew
        its path's recency (its real lookup does).
        """
        if not peek:
            self._tick += 1
        ps = self.page_size
        plen = len(prompt)
        max_full = max(0, (plen - 1) // ps)
        pages: List[int] = []
        node: Optional[_Node] = None
        level = self._roots
        for chunk in self._chunks(prompt)[:max_full]:
            nxt = level.get(chunk)
            if nxt is None:
                break
            if not peek:
                nxt.last_used = self._tick
            pages.append(nxt.page)
            node, level = nxt, nxt.children
        # partial-page match: the best child whose leading rows hold the
        # next tokens (divergence inside the page -> COW mount)
        rest = [int(t) for t in prompt[len(pages) * ps:]]
        best_m, best_page = 0, None
        cap = min(len(rest) - 1, ps)
        for chunk, child in level.items():
            m = 0
            while m < cap and chunk[m] == rest[m]:
                m += 1
            if m > best_m:
                best_m, best_page = m, child.page
                if not peek:
                    child.last_used = self._tick
        return PrefixHit(pages=pages, partial_page=best_page,
                         partial_tokens=best_m, _page_size=ps)

    def note(self, matched_tokens: int) -> None:
        """Record one ADMITTED request's reuse (the batcher calls this only
        when the reservation succeeds, so a back-pressured admission that
        retries its lookup next step is not double-counted)."""
        if matched_tokens > 0:
            self.hits += 1
            self.tokens_saved += int(matched_tokens)
        else:
            self.misses += 1

    def insert(self, prompt: Sequence[int], pages: Sequence[int]) -> int:
        """Index a prefilled prompt's FULL pages (`pages` is the owning
        slot's page list, in order).  Existing nodes are kept — a chunk
        already indexed stays bound to its original page (first writer
        wins); new nodes pin their page with one pool reference.  Returns
        the number of new entries.

        When ``max_pinned_pages`` is set, inserting past the cap first
        drops LRU leaf entries (never this insert's own pages); if nothing
        is evictable the insert stops early — the prefix up to that point
        is still indexed, deeper pages simply are not pinned."""
        self._tick += 1
        added = 0
        node: Optional[_Node] = None
        level = self._roots
        # protect this insert's own pages AND the nodes already walked on
        # its path (evicting a just-traversed leaf would orphan the
        # subtree about to attach under it)
        own = set(int(p) for p in pages)
        for i, chunk in enumerate(self._chunks(prompt)):
            nxt = level.get(chunk)
            if nxt is None:
                if (self.max_pinned_pages is not None
                        and self.entries >= self.max_pinned_pages
                        and self.evict(self.entries + 1
                                       - self.max_pinned_pages,
                                       exclude=own) == 0):
                    break
                page = int(pages[i])
                self.pool.incref(page)  # the index's pin
                nxt = _Node(chunk=chunk, page=page, parent=node)
                level[chunk] = nxt
                self.entries += 1
                added += 1
            nxt.last_used = self._tick
            own.add(nxt.page)
            node, level = nxt, nxt.children
        return added

    # ------------------------------------------------------------------

    def _leaves(self) -> List[_Node]:
        out: List[_Node] = []

        def walk(level):
            for n in level.values():
                if n.children:
                    walk(n.children)
                else:
                    out.append(n)

        walk(self._roots)
        return out

    def _drop(self, node: _Node) -> None:
        level = node.parent.children if node.parent else self._roots
        del level[node.chunk]
        self.entries -= 1
        self.pool.decref(node.page)

    def evict(self, need_pages: int, exclude=()) -> int:
        """Free up to `need_pages` pages by dropping LRU leaf entries whose
        page nobody else references (pool refcount 1 — the index's own
        pin).  A page a live slot still shares is PINNED: its entry is
        skipped, not dropped, so a re-admitted prefix keeps hitting it.
        ``exclude`` lists pages the caller is about to mount (the admission
        plan's own prefix hit) — evicting those would free pages the
        imminent try_reserve names as shared.  Cascades: a parent whose
        children were all evicted becomes a leaf candidate in the next
        round.  Returns pages actually freed."""
        exclude = set(int(p) for p in exclude)
        freed = 0
        while freed < need_pages:
            candidates = [n for n in self._leaves()
                          if self.pool.refcount(n.page) == 1
                          and n.page not in exclude]
            if not candidates:
                break
            victim = min(candidates, key=lambda n: n.last_used)
            self._drop(victim)
            freed += 1
            self.evicted_pages += 1
        return freed

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "entries": self.entries,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "tokens_saved": self.tokens_saved,
            "evicted_pages": self.evicted_pages,
            "pinned_pages": self.entries,  # one pool pin per entry
            "max_pinned_pages": self.max_pinned_pages,
        }
