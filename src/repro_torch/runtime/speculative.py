"""Speculative decoding: draft proposers and acceptance accounting (port of
`repro/runtime/speculative.py`).

Decode reads every weight and every resident KV byte to emit one token.
Speculative decoding drafts k cheap candidate tokens and scores all k+1
window positions in one batched verify pass
(`DecoderLM.verify_step_paged` -> `mx_flash_verify`), so those reads
amortize over up to k+1 emitted tokens.

The accept rule is greedy-exact: draft r is accepted iff it equals the
argmax the verify pass produced at the previous row, so the emitted stream
equals non-speculative greedy decode whatever the drafter proposes (a bad
drafter costs speed, never correctness).  Rejected drafts roll back for
free: their K/V rows sit in the slot's already-reserved pages, dead under
the length mask until real tokens overwrite them.

Drafters (host-side; `NGramDrafter` and `TraceDrafter` are numpy only):

  - ``NGramDrafter``       -- self-speculative prompt lookup: the most recent
    earlier occurrence of the sequence's trailing n-gram proposes the
    tokens that followed it (no model, no device work).
  - ``DraftModelProposer`` -- a small draft model sharing the target's token
    space, greedy-decoded k tokens ahead by full forwards
    (`DecoderLM.__call__`) over a bounded context suffix.  ``overlap`` < 1
    corrupts each proposal with that probability (seeded numpy, pure in
    (seed, history length), the same draws as the JAX package).
  - ``TraceDrafter``       -- replays known target streams with seeded
    corruption: zero proposal cost, exact acceptance-rate control.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..models.modules import param_device

__all__ = [
    "DraftProposer", "NGramDrafter", "DraftModelProposer", "TraceDrafter",
    "SpecStats", "accept_greedy",
]


class DraftProposer:
    """Interface: propose up to k draft tokens continuing `seq`.

    ``seq`` is the request's full token history (prompt + every emitted
    token); the returned array may be shorter than k (including empty —
    the batcher then runs a plain 1-row window for that slot).  Proposals
    are hints only: the greedy-exact accept rule makes correctness
    independent of what this returns."""

    def propose(self, seq: np.ndarray, k: int) -> np.ndarray:
        raise NotImplementedError


class NGramDrafter(DraftProposer):
    """Self-speculative prompt-lookup: match the trailing n-gram (longest
    first) against earlier positions of the sequence and propose the
    continuation of the MOST RECENT match.  Catches repetition — quoted
    spans, code idioms, degenerate cycles — at zero model cost."""

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not 1 <= min_n <= max_n:
            raise ValueError(f"need 1 <= min_n <= max_n, got {min_n}..{max_n}")
        self.max_n = max_n
        self.min_n = min_n

    def propose(self, seq: np.ndarray, k: int) -> np.ndarray:
        seq = np.asarray(seq)
        L = len(seq)
        if k <= 0 or L < self.min_n + 1:
            return np.zeros((0,), np.int32)
        for n in range(min(self.max_n, L - 1), self.min_n - 1, -1):
            pat = seq[L - n:]
            # windows of width n over seq[:-1]; rightmost match wins
            wins = np.lib.stride_tricks.sliding_window_view(seq[:-1], n)
            hits = np.flatnonzero((wins == pat).all(axis=1))
            if hits.size:
                j = int(hits[-1]) + n  # continuation start
                return seq[j:j + k].astype(np.int32)
        return np.zeros((0,), np.int32)


class DraftModelProposer(DraftProposer):
    """Greedy k-token lookahead with a small draft model sharing the
    target's token space (same vocab ids — no tokenizer translation).

    Each proposal token is one full forward of the draft model over the
    last ``max_context`` tokens, padded to a power of two (as JAX pads to
    bound its retraces, so both packages run the same shapes).
    ``overlap`` < 1.0 corrupts each proposed token with probability
    1-overlap (seeded rng, pure in (seed, history length, draft index)) —
    the benchmark's acceptance-rate dial; 1.0 means "propose exactly what
    the draft model believes"."""

    def __init__(self, model, params, *, max_context: int = 64,
                 overlap: float = 1.0, seed: int = 0):
        if not 0.0 <= overlap <= 1.0:
            raise ValueError(f"overlap must be in [0, 1], got {overlap}")
        self.model = model
        self.params = params
        self.max_context = int(max_context)
        self.overlap = float(overlap)
        self.seed = int(seed)
        self.vocab = int(model.cfg.vocab)
        self.forwards = 0  # draft-model forwards spent drafting
        self.device = param_device(params)

    def _next(self, ctx: np.ndarray) -> int:
        """Greedy next token of the draft model after `ctx`: one forward over
        ctx padded to a power of two, read at the last real position (the
        causal mask keeps the padding out of it)."""
        n = len(ctx)
        width = 1 if n <= 1 else 1 << (n - 1).bit_length()
        toks = np.zeros((1, width), np.int64)
        toks[0, :n] = ctx
        self.forwards += 1
        with torch.no_grad():
            logits, _ = self.model(self.params, torch.as_tensor(toks, device=self.device))
        # torch.argmax, like jnp.argmax, takes the first maximal index
        return int(logits[0, n - 1].argmax())

    def propose(self, seq: np.ndarray, k: int) -> np.ndarray:
        seq = np.asarray(seq)
        if k <= 0 or len(seq) == 0:
            return np.zeros((0,), np.int32)
        rng = (np.random.default_rng([self.seed, len(seq)])
               if self.overlap < 1.0 else None)
        ctx = list(seq[-self.max_context:])
        out = []
        for _ in range(k):
            t = self._next(np.asarray(ctx, np.int32))
            if rng is not None and rng.random() >= self.overlap:
                t = (t + 1) % self.vocab  # guaranteed-wrong corruption
            out.append(t)
            ctx = (ctx + [t])[-self.max_context:]
        return np.asarray(out, np.int32)


class TraceDrafter(DraftProposer):
    """Replay known target streams with controllable overlap — the
    zero-cost acceptance dial for benchmarks and tests.

    ``traces`` maps each request's expected FULL token sequence (prompt +
    reference greedy output, as a tuple) to itself; `propose` finds the
    trace this history is a prefix of and proposes its continuation,
    corrupting each token with probability 1-overlap (seeded, pure in
    (seed, history length)).  Histories that diverge from every trace
    (e.g. after a corrupted draft was rejected and the true token
    emitted... which re-joins the trace) propose nothing."""

    def __init__(self, traces: Sequence[Sequence[int]], *,
                 overlap: float = 1.0, seed: int = 0):
        if not 0.0 <= overlap <= 1.0:
            raise ValueError(f"overlap must be in [0, 1], got {overlap}")
        self.traces = [tuple(int(t) for t in tr) for tr in traces]
        self.overlap = float(overlap)
        self.seed = int(seed)

    def propose(self, seq: np.ndarray, k: int) -> np.ndarray:
        if k <= 0:
            return np.zeros((0,), np.int32)
        hist = tuple(int(t) for t in seq)
        L = len(hist)
        for tr in self.traces:
            if len(tr) > L and tr[:L] == hist:
                out = np.asarray(tr[L:L + k], np.int32)
                if self.overlap < 1.0 and out.size:
                    rng = np.random.default_rng([self.seed, L])
                    flip = rng.random(out.size) >= self.overlap
                    out = np.where(flip, (out + 1) % (out.max() + 2), out)
                return out.astype(np.int32)
        return np.zeros((0,), np.int32)


@dataclasses.dataclass
class SpecStats:
    """Aggregate acceptance accounting across a batcher's verify launches.

    ``launches`` counts device verify steps; ``windows`` counts slot-steps
    that actually carried drafts (a slot with k=0 that step is excluded
    from the acceptance rate — it had nothing to accept).  ``emitted``
    counts every token emitted through the verify path, drafted or not, so
    ``tokens_per_launch`` is the goodput the launch-amortization argument
    promises (1.0 == plain decode)."""

    launches: int = 0
    windows: int = 0
    drafted: int = 0
    accepted: int = 0
    emitted: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0

    @property
    def tokens_per_launch(self) -> float:
        return self.emitted / self.launches if self.launches else 0.0

    def as_dict(self) -> dict:
        return {
            "launches": self.launches,
            "windows": self.windows,
            "drafted": self.drafted,
            "accepted": self.accepted,
            "emitted": self.emitted,
            "acceptance_rate": self.acceptance_rate,
            "tokens_per_launch": self.tokens_per_launch,
        }


def accept_greedy(drafts: Sequence[int],
                  argmax_rows: Sequence[int]) -> Tuple[list, int]:
    """The greedy-exact accept rule, shared by the batcher and tests.

    ``argmax_rows[r]`` is the verify pass's argmax at window row r (the
    token the model emits AFTER consuming rows 0..r).  Row 0 is always
    emitted — it is exactly the plain decode step's output.  Draft r
    (fed at row r+1) is accepted iff it equals the previous row's argmax;
    the first mismatch stops the window (later rows were scored against a
    wrong prefix).  Returns (emitted tokens, accepted draft count)."""
    emitted = [int(argmax_rows[0])]
    a = 0
    for r, d in enumerate(drafts):
        if int(d) != emitted[-1]:
            break
        emitted.append(int(argmax_rows[r + 1]))
        a += 1
    return emitted, a
