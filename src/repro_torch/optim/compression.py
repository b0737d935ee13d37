"""Gradient compression for the data-parallel all-reduce: int8 with error
feedback (port of `repro/optim/compression.py`).

Quantizing a gradient to int8 cuts the all-reduce's bytes 4x (f32); error
feedback carries each step's quantization residual into the next, so the
sequence of updates stays unbiased.

  - `compress_with_feedback`: (grad, residual) -> (int8 payload, scale,
    new residual), bitwise JAX's;
  - `compressed_grad_sync`: the all-reduce over a mesh axis with the int8
    wire format, over the axis's ring (`mesh.ring(axis)`, `parallel/
    ring.py`): the ranks' dequantized contributions summed in rank order
    (`ring.psum`), divided by the ring's size.  One body for `LocalRing`
    (every rank in this process) and `DistRing` (one rank per process).

The quantizer lives in `kernels/quant.py` (`quantize_int8_tensor`),
re-exported here under the names JAX's module uses.  Wire format: int8
payload, scalar f32 scale = amax / 127, clipped to +-127.
"""
from __future__ import annotations

from typing import Any

import torch

from ..core import tree as tree_util
from ..kernels.quant import dequantize, quantize_int8_tensor as quantize  # noqa: F401


def compress_with_feedback(g: torch.Tensor, err: torch.Tensor):
    """(grad, residual) -> (int8 payload, scale, new residual)."""
    corrected = g.float() + err
    q, scale = quantize(corrected)
    new_err = corrected - dequantize(q, scale)
    return q, scale, new_err


def compressed_grad_sync(grads: Any, err_state: Any, mesh, axis: str = "pod"):
    """All-reduce `grads` over `axis` with the int8 wire format and error
    feedback.  grads / err_state: matching trees, the values of the ranks
    this process holds (replicated over them, as JAX's `P()` spec has
    them; a `DistRing` process holds its own rank's).  Returns (synced f32
    mean, new error state)."""
    ring = mesh.ring(axis)
    n = float(ring.size)

    def sync_leaf(g, err):
        with torch.no_grad():
            q, scale, new_err = compress_with_feedback(g, err)
            # the wire: each rank's int8 payload and f32 scale, summed
            # dequantized in rank order
            total = ring.psum([dequantize(q, scale)] * len(ring.ranks))
            return total / n, new_err

    out = [sync_leaf(g, e) for g, e in zip(tree_util.leaves(grads),
                                           tree_util.leaves(err_state))]
    return (tree_util.unflatten(grads, [o[0] for o in out]),
            tree_util.unflatten(grads, [o[1] for o in out]))


def init_error_state(grads: Any) -> Any:
    return tree_util.map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                         grads)
