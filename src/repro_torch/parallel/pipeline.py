"""GPipe-style pipeline parallelism over a mesh axis (port of
`repro/parallel/pipeline.py`, forward only).

`gpipe_apply` runs a stage function over S pipeline stages on the `axis`
ring of the mesh (`parallel/ring.py`), streaming M microbatches through
the fill / compute / drain schedule: at time t in [0, M+S-1) stage s takes
microbatch t-s, and the last stage emits microbatch t-(S-1).  The bubble
is (S-1)/(M+S-1) of the stage-steps.  JAX computes its stages on the
bubble's garbage too (one SPMD program); the port skips those steps, whose
results never reach an output.

JAX gets the backward pipeline from reverse-mode AD through `ppermute`.
Here the gradient comes with training (ROADMAP queue 1 item 8): the ring
hops are not autograd-aware.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..kernels.mx_collective_matmul import ring_perm


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def gpipe_apply(stage_fn: Callable, stage_params, x_microbatches: torch.Tensor, *, mesh,
                axis: str = "pod") -> torch.Tensor:
    """Run the pipeline.

    stage_fn:       (params_one_stage, activation) -> activation (same shape)
    stage_params:   tree with a leading stage dim of size S == mesh.shape[axis]
    x_microbatches: (M, mb, ...) -- M microbatches
    returns         (M, mb, ...) the last stage's outputs, on every process
    """
    ring = mesh.ring(axis)
    S, stages = ring.size, ring.ranks
    M = x_microbatches.shape[0]
    assert M >= 1
    params = [_tree_map(lambda t, s=s: t[s], stage_params) for s in stages]
    perm = ring_perm(S)
    state = [torch.zeros_like(x_microbatches[0]) for _ in stages]
    outputs = [torch.zeros_like(x_microbatches) for _ in stages]
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
            state = ring.permute(outs, perm).wait()
    # the last stage's outputs on every rank: psum of a one-hot contribution
    return ring.psum([o if s == S - 1 else torch.zeros_like(o)
                      for o, s in zip(outputs, stages)])


def bubble_fraction(n_microbatches: int, n_stages: int) -> float:
    """GPipe bubble overhead: (S-1)/(M+S-1)."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
