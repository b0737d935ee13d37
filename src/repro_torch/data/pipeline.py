"""Deterministic synthetic data pipeline: host-sharded, seekable, prefetched
(the port's copy of `repro/data/pipeline.py`; numpy only, so its batches
are bitwise the JAX package's, and the train step moves them to the
device).

Real-deployment properties preserved here:
  - per-host sharding (host_id/host_count) so each data-parallel host reads
    a disjoint stream;
  - seekability (`seek(step)`) — restart-from-checkpoint needs the pipeline
    to resume at an exact step without replaying;
  - background prefetch (producer thread + bounded queue) so host input
    never blocks the device step;
  - batch layout matches JAX's launch/specs.py exactly (tokens/labels [+ frames /
    pixel_embeds for the modality archs]).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np

from ..configs.base import ArchConfig


@dataclasses.dataclass
class SyntheticLM:
    cfg: ArchConfig
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    host_count: int = 1

    def __post_init__(self):
        assert self.global_batch % self.host_count == 0
        self.local_batch = self.global_batch // self.host_count
        self._step = 0

    def seek(self, step: int):
        self._step = step

    @property
    def step(self) -> int:
        return self._step

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id])
        )

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = self._rng(self._step)
        self._step += 1
        cfg = self.cfg
        B, S = self.local_batch, self.seq_len
        if cfg.model_kind == "encdec":
            se = S // 2
            toks = rng.integers(0, cfg.vocab, (B, se + 1), dtype=np.int32)
            return {
                "frames": rng.standard_normal((B, se, cfg.frontend_dim)).astype(np.float32) * 0.1,
                "tokens": toks[:, :-1],
                "labels": toks[:, 1:],
            }
        if cfg.frontend_dim:
            Pfx = cfg.frontend_tokens
            St = S - Pfx
            toks = rng.integers(0, cfg.vocab, (B, St + 1), dtype=np.int32)
            return {
                "pixel_embeds": rng.standard_normal((B, Pfx, cfg.frontend_dim)).astype(np.float32) * 0.1,
                "tokens": toks[:, :-1],
                "labels": toks[:, 1:],
            }
        # LM stream with learnable structure (repetition) so smoke training
        # visibly reduces loss rather than staying at ln(V):
        half = rng.integers(0, cfg.vocab, (B, (S + 2) // 2 + 1), dtype=np.int32)
        toks = np.concatenate([half, half], axis=1)[:, : S + 1].astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()


class Prefetcher:
    """Producer-thread prefetch with a bounded queue."""

    def __init__(self, source, depth: int = 2):
        self._source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            batch = self._source.next_batch()
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def next_batch(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
