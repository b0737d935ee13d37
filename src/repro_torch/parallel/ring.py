"""Ring transports of the port's tensor and pipeline parallelism: what XLA's
`ppermute` / `psum` / `all_gather` give the JAX package inside `shard_map`.

A ring body (`kernels/mx_collective_matmul.py`, `parallel/pipeline.py`) is
written once for both transports.  Every per-rank value is a list over the
ranks this process holds (`ring.ranks`, the axis index of each position):
all P of them for `LocalRing`, one for `DistRing`.

  - `permute(values, perm)` starts one hop of the ring (`perm` the (src,
    dst) pairs of `ring_perm`) and returns a `Pending`; `.wait()` gives the
    received values, position by position.
  - `psum(values)` is the sum over every rank of the ring, added in rank
    order (the same tensor on every process).
  - `gather(values, dim)` is the concatenation over every rank, in rank
    order, along `dim`.

`LocalRing(size)` holds every rank in this process (the one-card ring).  On
CPU tensors a hop hands the tensors on; on CUDA tensors it copies them on a
side stream, which waits on an event recorded after the producing work,
while the consumer waits on the copy's event only when it takes the values
(`Pending.wait`); every buffer handed across the streams is marked with
`record_stream`, so the caching allocator does not reuse it before the copy
is done.  `sync=True` copies on the current stream instead (the reference
for the stream ordering).  `bytes_moved` counts the bytes the hops move.

`DistRing(group)` holds one rank per process over `torch.distributed`:
hops are `batch_isend_irecv` pairs, tagged by call order (every rank issues
the same sequence, and a two-rank ring's two directions share one peer);
`psum` and `gather` all-gather the ranks' values and combine them in rank
order, so the results are bitwise `LocalRing`'s.  gloo on the CPU, NCCL on
several cards.

Autograd (JAX differentiates `ppermute` and `psum` inside `shard_map`):
when grad is enabled and a value requires grad, `permute` and `psum` run
through a `torch.autograd.Function` over the per-rank lists, one for both
transports.  permute's backward is the inverse permute of the output
gradients (on the card, the same side-stream copies, ordered by the same
events); psum's is a psum of the output gradients: every process holds
the sum once, so each rank's input gradient is the sum over processes of
their output gradients (on a `LocalRing`, the one output gradient).  On a
`DistRing` each process runs its own backward, and a hop's backward is an
exchange with the neighbours: every process must take the autograd path
for the same hops and run their backward in the same order, which the
ring body arranges (`parallel/pipeline.gpipe_apply`).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class Pending:
    """A started hop; `wait()` returns the received values (once)."""

    def __init__(self, wait: Callable[[], List[torch.Tensor]]):
        self._wait = wait
        self._values: Optional[List[torch.Tensor]] = None

    def wait(self) -> List[torch.Tensor]:
        if self._values is None:
            self._values = self._wait()
        return self._values


def _sources(perm: Sequence[Tuple[int, int]], ranks: Sequence[int]) -> List[int]:
    src_of = {dst: src for src, dst in perm}
    return [src_of[r] for r in ranks]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Permute(torch.autograd.Function):
    """One hop of the ring over the per-rank lists, differentiable."""

    @staticmethod
    def forward(ctx, ring, perm, *values):
        ctx.ring, ctx.inverse = ring, [(dst, src) for src, dst in perm]
        return tuple(ring._permute(values, perm).wait())

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.ring._permute(grads, ctx.inverse).wait())


class _Psum(torch.autograd.Function):
    """The sum over every rank of the ring, differentiable."""

    @staticmethod
    def forward(ctx, ring, *values):
        ctx.ring, ctx.n = ring, len(values)
        return ring._psum(values)

    @staticmethod
    def backward(ctx, g):
        # this process's output gradient on its first rank: the sum over
        # processes of their output gradients (LocalRing: g itself)
        total = ctx.ring._psum([g] + [torch.zeros_like(g)] * (ctx.n - 1))
        return (None, *([total] * ctx.n))


def _differentiable(values) -> bool:
    return torch.is_grad_enabled() and any(v.requires_grad for v in values)


class _Ring:
    """The differentiable front of a transport (`_permute`, `_psum`)."""

    def permute(self, values: Sequence[torch.Tensor], perm) -> Pending:
        if _differentiable(values):
            outs = list(_Permute.apply(self, list(perm), *values))
            return Pending(lambda: outs)
        return self._permute(values, perm)

    def psum(self, values: Sequence[torch.Tensor]) -> torch.Tensor:
        if _differentiable(values):
            return _Psum.apply(self, *values)
        return self._psum(values)


class LocalRing(_Ring):
    """All `size` ranks of the ring in this process."""

    def __init__(self, size: int, *, sync: bool = False):
        if size < 1:
            raise ValueError(f"ring size must be >= 1, got {size}")
        self.size = size
        self.ranks = tuple(range(size))
        self.sync = sync
        self.bytes_moved = 0
        self._streams = {}

    def side_stream(self, device: torch.device) -> "torch.cuda.Stream":
        """The side stream the hops of CUDA tensors on `device` copy on."""
        key = torch.device(device).index or 0
        if key not in self._streams:
            self._streams[key] = torch.cuda.Stream(device=device)
        return self._streams[key]

    def _permute(self, values: Sequence[torch.Tensor], perm) -> Pending:
        srcs = _sources(perm, self.ranks)
        moved = [values[s] for s in srcs]
        self.bytes_moved += sum(_nbytes(t) for t in moved)
        if not moved[0].is_cuda:
            return Pending(lambda: moved)
        outs = [torch.empty_like(t) for t in moved]
        if self.sync:
            for o, t in zip(outs, moved):
                o.copy_(t)
            return Pending(lambda: outs)
        cur = torch.cuda.current_stream(moved[0].device)
        side = self.side_stream(moved[0].device)
        side.wait_stream(cur)  # the producing work is enqueued before the copies
        with torch.cuda.stream(side):
            for o, t in zip(outs, moved):
                o.copy_(t, non_blocking=True)
        for t in (*moved, *outs):
            t.record_stream(side)
        done = torch.cuda.Event()
        done.record(side)

        def wait():
            cur.wait_event(done)
            return outs

        return Pending(wait)

    def _psum(self, values: Sequence[torch.Tensor]) -> torch.Tensor:
        total = values[0]
        for v in values[1:]:
            total = total + v
        return total

    def gather(self, values: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        return torch.cat(list(values), dim=dim)


class DistRing(_Ring):
    """One rank of the ring per process, over a `torch.distributed` group
    (None: the default group)."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.ranks = (self.rank,)
        self.bytes_moved = 0
        self._tag = 0

    def _peer(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def _permute(self, values: Sequence[torch.Tensor], perm) -> Pending:
        (v,) = values
        dst = dict(perm)[self.rank]
        (src,) = _sources(perm, self.ranks)
        if dst == self.rank:
            return Pending(lambda: [v])
        send = v.contiguous()
        recv = torch.empty_like(send)
        tag, self._tag = self._tag, (self._tag + 1) % (1 << 20)
        self.bytes_moved += _nbytes(send)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, self._peer(dst), self.group, tag),
            dist.P2POp(dist.irecv, recv, self._peer(src), self.group, tag)])

        def wait(keep=send):  # the send buffer lives until the hop is done
            for r in reqs:
                r.wait()
            return [recv]

        return Pending(wait)

    def _all(self, v: torch.Tensor) -> List[torch.Tensor]:
        v = v.contiguous()
        parts = [torch.empty_like(v) for _ in range(self.size)]
        dist.all_gather(parts, v, group=self.group)
        return parts

    def _psum(self, values: Sequence[torch.Tensor]) -> torch.Tensor:
        (v,) = values
        parts = self._all(v)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total

    def gather(self, values: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        (v,) = values
        return torch.cat(self._all(v), dim=dim)
