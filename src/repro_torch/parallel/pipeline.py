"""GPipe-style pipeline parallelism over a mesh axis (port of
`repro/parallel/pipeline.py`).

`gpipe_apply` runs a stage function over S pipeline stages on the `axis`
ring of the mesh (`parallel/ring.py`), streaming M microbatches through
the fill / compute / drain schedule: at time t in [0, M+S-1) stage s takes
microbatch t-s, and the last stage emits microbatch t-(S-1).  The bubble
is (S-1)/(M+S-1) of the stage-steps.  JAX computes its stages on the
bubble's garbage too (one SPMD program); the port skips those steps, whose
results never reach an output.

The backward pipeline comes from autograd through the ring's hops, as
JAX's comes from AD through `ppermute`: a hop's backward is the inverse
permute, the final psum's a psum (`parallel/ring.py`).  On a `DistRing`
each process runs its own backward, and a hop's backward is an exchange
with the neighbours, so every process must run every hop's backward, in
the same order, whatever inputs the caller differentiates: every value a
hop or the psum takes is joined to the differentiable inputs (`_Join`, no
gradient flows through the join), and every hop's received values are
anchored to the output (`_Anchor`, a zero gradient).  Then each hop's node
lies between the output and every input on every process, and the engine
runs the psum's backward, then the hops' from the last to the first.
Each process's loss must come from its output (e.g. `0 * out.sum()` on a
process that has none).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core import tree as tree_util
from ..kernels.mx_collective_matmul import ring_perm


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class _Join(torch.autograd.Function):
    """`v` unchanged, its node tied to `anchors` (the inputs being
    differentiated) without a gradient to them: a hop's backward is never
    pruned from a process's graph."""

    @staticmethod
    def forward(ctx, v, *anchors):
        ctx.n = len(anchors)
        return v.view_as(v)

    @staticmethod
    def backward(ctx, g):
        return (g, *([None] * ctx.n))


class _Anchor(torch.autograd.Function):
    """`out`, with the hops' received values in its graph: their gradient
    is zero, but every hop's backward runs on every process."""

    @staticmethod
    def forward(ctx, out, *received):
        ctx.received = [(r.shape, r.dtype, r.device) for r in received]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=dev) for s, d, dev in ctx.received))


def gpipe_apply(stage_fn: Callable, stage_params, x_microbatches: torch.Tensor, *, mesh,
                axis: str = "pod") -> torch.Tensor:
    """Run the pipeline.

    stage_fn:       (params_one_stage, activation) -> activation (same shape)
    stage_params:   tree with a leading stage dim of size S == mesh.shape[axis]
    x_microbatches: (M, mb, ...) -- M microbatches
    returns         (M, mb, ...) the last stage's outputs, on every process

    Differentiable in `stage_params` and `x_microbatches` when grad is
    enabled and either requires grad.  On a `DistRing` every process holds
    the whole `stage_params`, and its gradient lands on the slice of the
    stage the process runs."""
    ring = mesh.ring(axis)
    S, stages = ring.size, ring.ranks
    M = x_microbatches.shape[0]
    assert M >= 1
    anchors = [t for t in (x_microbatches, *tree_util.leaves(stage_params)) if t.requires_grad]
    train = torch.is_grad_enabled() and bool(anchors)

    def joined(values):
        return [_Join.apply(v, *anchors) for v in values] if train else values

    params = [_tree_map(lambda t, s=s: t[s], stage_params) for s in stages]
    perm = ring_perm(S)
    state = [torch.zeros_like(x_microbatches[0]) for _ in stages]
    outputs = [torch.zeros_like(x_microbatches) for _ in stages]
    received = []
    for t in range(M + S - 1):
        outs = []
        for i, s in enumerate(stages):
            inp = x_microbatches[min(t, M - 1)] if s == 0 else state[i]
            # stage s holds microbatch t - s; outside [0, M) the bubble
            outs.append(stage_fn(params[i], inp) if 0 <= t - s < M else inp)
            j = t - (S - 1)
            if s == S - 1 and j >= 0:
                outputs[i][j] = outs[i]
        if t < M + S - 2:
            state = ring.permute(joined(outs), perm).wait()
            if train:
                received += state
    # the last stage's outputs on every rank: psum of a one-hot contribution
    last = [o if s == S - 1 else torch.zeros_like(o) for o, s in zip(outputs, stages)]
    if not train:
        return ring.psum(last)
    return _Anchor.apply(ring.psum(joined(last)), *received)


def bubble_fraction(n_microbatches: int, n_stages: int) -> float:
    """GPipe bubble overhead: (S-1)/(M+S-1)."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
