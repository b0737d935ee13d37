"""Grouped (ragged) MX GEMM: all experts of an MoE layer in one launch
(port of `repro/kernels/mx_grouped_matmul.py`, dense operands).

`mx_grouped_matmul` computes out[t] = act(x[t] @ w[g(t)]) for rows sorted
by group.  On a CUDA tensor it launches `csrc/mx_grouped_matmul.cu`: one
CTA per output tile reads the group sizes from the device itself (no host
sync), runs a whole K loop per overlapping non-empty group with f32
register accumulators and stores only that group's rows, so every output
row is written once.  On a CPU tensor it runs the plain version,
`kernels.ref.grouped_matmul_ref`.

Not ported yet (they raise NotImplementedError naming the ROADMAP item):
per-expert dequant scales (ROADMAP queue 2 item 5b), 2:4 sparse experts
(5c) and per-expert ABFT checksums (5d).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .mx_matmul import ACT_CODES, ACTIVATIONS, _require_cuda_operand
from .ref import grouped_matmul_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)


def _launch(x, w, w_gate, group_sizes, activation, out_dtype):
    T, K = x.shape
    G, _, N = w.shape
    dt = _build.dtype_code(x.dtype, "mx_grouped_matmul operands")
    for t, what in ((w, "w"), (w_gate, "w_gate")):
        if t is not None and t.dtype != x.dtype:
            raise TypeError(f"mx_grouped_matmul: {what} dtype {t.dtype} != x dtype "
                            f"{x.dtype} (mixed operands are not ported)")
    _require_cuda_operand(x, "x", x.device)
    _require_cuda_operand(w, "w", x.device)
    if w_gate is not None:
        _require_cuda_operand(w_gate, "w_gate", x.device, tuple(w.shape))
    if group_sizes.device != x.device:
        raise ValueError(f"group_sizes is on {group_sizes.device}, expected {x.device}")
    sizes = group_sizes.to(torch.int32).contiguous()
    out = torch.empty((T, N), dtype=out_dtype, device=x.device)
    if T == 0 or N == 0:
        return out
    fn = _build.function("mx_grouped_matmul", "mx_grouped_matmul_launch", _ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(),
             None if w_gate is None else w_gate.data_ptr(), sizes.data_ptr(),
             out.data_ptr(), _build.dtype_code(out_dtype, "out_dtype"), T, N, K, G, dt,
             ACT_CODES[activation], _build.stream_ptr(x))
    _build.check(err, "mx_grouped_matmul", "mx_grouped_matmul")
    mx_grouped_matmul.launches += 1
    return out


def mx_grouped_matmul(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor, *,
                      w_gate: Optional[torch.Tensor] = None, activation: str = "none",
                      a_scale=None, b_scale=None, bg_scale=None, b_sparse: bool = False,
                      w_meta=None, wg_meta=None, out_dtype=None,
                      abft=None) -> torch.Tensor:
    """out[t] = act(x[t] @ w[g(t)]).  x: (T, K) rows sorted by group; w:
    (G, K, N); group_sizes: (G,) ints, on x's device.  Rows at or past
    sum(group_sizes) are zero; oversubscribed sizes (sum > T) drop the rows
    that do not exist.  activation "swiglu" gates with w_gate (G, K, N):
    silu(x @ w_gate[g]) * (x @ w[g]).  out_dtype defaults to x.dtype.

    A CUDA `x` launches the kernel (f32 or bf16 operands, f32 or bf16
    output); a CPU `x` takes `grouped_matmul_ref`."""
    if a_scale is not None or b_scale is not None or bg_scale is not None:
        raise NotImplementedError(
            "per-expert dequant scales (a_scale/b_scale) are not ported yet: "
            "ROADMAP queue 2 item 5b")
    if b_sparse or w_meta is not None or wg_meta is not None:
        raise NotImplementedError(
            "2:4 sparse experts are not ported yet: ROADMAP queue 2 item 5c")
    if abft is not None:
        raise NotImplementedError(
            "per-expert ABFT checksums are not ported yet: ROADMAP queue 2 item 5d")
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"expected x (T, K), w (G, K, N); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if x.shape[1] != w.shape[1]:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)} vs w {tuple(w.shape)}")
    if tuple(group_sizes.shape) != (w.shape[0],):
        raise ValueError(f"group_sizes must have shape ({w.shape[0]},) to match w's "
                         f"leading dim; got {tuple(group_sizes.shape)}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; one of {ACTIVATIONS}")
    if (activation == "swiglu") != (w_gate is not None):
        raise ValueError("w_gate must be given iff activation=='swiglu'")
    if w_gate is not None and w_gate.shape != w.shape:
        raise ValueError(f"w_gate {tuple(w_gate.shape)} != w {tuple(w.shape)}")
    out_dtype = out_dtype or x.dtype
    if x.is_cuda:
        return _launch(x, w, w_gate, group_sizes, activation, out_dtype)
    return grouped_matmul_ref(x, w, group_sizes, w_gate=w_gate, activation=activation,
                              out_dtype=out_dtype)


mx_grouped_matmul.launches = 0  # kernel launches (CUDA tensors only)
