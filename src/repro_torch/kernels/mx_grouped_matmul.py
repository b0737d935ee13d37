"""Grouped (ragged) MX GEMM: all experts of an MoE layer in one launch
(port of `repro/kernels/mx_grouped_matmul.py`, dense operands).

`mx_grouped_matmul` computes out[t] = act(x[t] @ w[g(t)]) for rows sorted
by group.  On a CUDA tensor it launches `csrc/mx_grouped_matmul.cu`: one
CTA per output tile reads the group sizes from the device itself (no host
sync), runs a whole K loop per overlapping non-empty group with f32
register accumulators and stores only that group's rows, so every output
row is written once.  On a CPU tensor it runs the plain version,
`kernels.ref.grouped_matmul_ref`.

Quantized experts (stage 5b): x and w carry int8 / fp8 payloads (or bf16
casts), with per-row `a_scale` (T, 1) and per-expert per-column `b_scale`
/ `bg_scale` (G, 1, N) f32 scales applied at the store of each group's
rows; the operand pairs are those of `mx_matmul_fused`.

Not ported yet (they raise NotImplementedError naming the ROADMAP item):
2:4 sparse experts (queue 2 item 5c) and per-expert ABFT checksums (5d).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .mx_matmul import ACT_CODES, ACTIVATIONS, _require_cuda_operand, _scale_vec
from .ref import grouped_matmul_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 8 + (_I,) * 8 + (_P,)


def _launch(x, w, w_gate, group_sizes, activation, a_scale, b_scale, bg_scale,
            out_dtype):
    T, K = x.shape
    G, _, N = w.shape
    x_dt, w_dt = _build.pair_codes(x, w, "mx_grouped_matmul")
    if w_gate is not None and w_gate.dtype != w.dtype:
        raise TypeError(f"mx_grouped_matmul: w_gate dtype {w_gate.dtype} != w dtype "
                        f"{w.dtype}")
    _require_cuda_operand(x, "x", x.device)
    _require_cuda_operand(w, "w", x.device)
    if w_gate is not None:
        _require_cuda_operand(w_gate, "w_gate", x.device, tuple(w.shape))
    if group_sizes.device != x.device:
        raise ValueError(f"group_sizes is on {group_sizes.device}, expected {x.device}")
    scales = [_scale_vec(t, n, what, x.device) for t, n, what in (
        (a_scale, T, "a_scale"), (b_scale, G * N, "b_scale"), (bg_scale, G * N, "bg_scale"))]
    sizes = group_sizes.to(torch.int32).contiguous()
    out = torch.empty((T, N), dtype=out_dtype, device=x.device)
    if T == 0 or N == 0:
        return out
    fn = _build.function("mx_grouped_matmul", "mx_grouped_matmul_launch", _ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(),
             None if w_gate is None else w_gate.data_ptr(),
             *(None if t is None else t.data_ptr() for t in scales), sizes.data_ptr(),
             out.data_ptr(), _build.dtype_code(out_dtype, "out_dtype"), T, N, K, G, x_dt,
             w_dt, ACT_CODES[activation], _build.stream_ptr(x))
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
    silu(x @ w_gate[g]) * (x @ w[g]).  Quantized payloads carry a_scale
    (T, 1) and per-expert b_scale / bg_scale (G, 1, N); bg_scale is given
    iff gated and b_scale is.  out_dtype defaults to x.dtype; pass it for
    quantized payloads.

    A CUDA `x` launches the kernel (the operand pairs of `mx_matmul_fused`,
    f32 or bf16 output); a CPU `x` takes `grouped_matmul_ref`."""
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
    if (bg_scale is not None) != (activation == "swiglu" and b_scale is not None):
        raise ValueError("bg_scale must be given iff gated AND b_scale is set")
    T, (G, _, N) = x.shape[0], w.shape
    for t, shape, what in ((a_scale, (T, 1), "a_scale"), (b_scale, (G, 1, N), "b_scale"),
                           (bg_scale, (G, 1, N), "bg_scale")):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{what} must be {shape}, got {tuple(t.shape)}")
    out_dtype = out_dtype or x.dtype
    if x.is_cuda:
        return _launch(x, w, w_gate, group_sizes, activation, a_scale, b_scale, bg_scale,
                       out_dtype)
    return grouped_matmul_ref(x, w, group_sizes, w_gate=w_gate, activation=activation,
                              a_scale=a_scale, b_scale=b_scale, bg_scale=bg_scale,
                              out_dtype=out_dtype)


mx_grouped_matmul.launches = 0  # kernel launches (CUDA tensors only)
