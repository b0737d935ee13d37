"""Grouped (ragged) MX GEMM: all experts of an MoE layer in one launch
(port of `repro/kernels/mx_grouped_matmul.py`, dense operands).

`mx_grouped_matmul` computes out[t] = act(x[t] @ w[g(t)]) for rows sorted
by group.  On a CUDA tensor it launches `csrc/mx_grouped_matmul.cu`: one
CTA per output tile reads the group sizes from the device itself (no host
sync), runs a whole K loop per overlapping non-empty group and stores only
that group's rows, so every output row is written once.  The K loop is
`_build.grouped_tile`'s (`mx_matmul.grouped_route`: "mma" for every pair,
`csrc/grouped_mma.cuh`: the fused GEMM's tensor-core prefill loop per
group -- 3xTF32 for f32, bf16 m16n8k16, an int8 or e4m3 weight beside bf16
widened exactly, int8 x int8 on the s8 m16n8k32 MMA, e4m3 x e4m3 widened
exactly to f16 in registers --
the weight streamed through a ring of 16-byte copies, K cut into parts by
K alone, so every variant -- and the fused GEMM on one expert's rows --
gets the same bits).  On a CPU tensor it runs the plain version,
`kernels.ref.grouped_matmul_ref`.

Quantized experts (stage 5b): x and w carry int8 / fp8 payloads (or bf16
casts), with per-row `a_scale` (T, 1) and per-expert per-column `b_scale`
/ `bg_scale` (G, 1, N) f32 scales applied at the store of each group's
rows; the operand pairs are those of `mx_matmul_fused`.

2:4 sparse experts (stage 5c): w / w_gate carry per-expert payloads
(G, K/2, N) with uint8 metadata (G, K/8, N), expanded in shared memory by
`csrc/mx_grouped_matmul_sparse.cu`.  Per-expert ABFT (stage 5d): with
``abft`` the call returns (out, flags) over `_build.grouped_flag_tile`'s
tiles, each group visit verified and the verdicts of a straddled tile OR-ed
(`csrc/mx_grouped_matmul_abft.cu`).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .abft import AbftSpec, make_abft_spec
from .mx_matmul import (ACT_CODES, ACTIVATIONS, _check_variant_args, _fault_operands, _ptr,
                        _require_cuda_operand, _scale_vec)
from .ref import grouped_matmul_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# x, w, w_gate, [w_meta, wg_meta], a_scale, b_scale, bg_scale, sizes, out,
# then _TAIL (out_dt, T, N, K, G, x_dt, w_dt, act), then the tile (bm, bn,
# stages, split, parts, va, vb, vm); then [flags, fault_delta, fault_row,
# fault_col, rtol, atol], stream
_TAIL, _MMA = (_I,) * 8, (_I,) * 8
_LAUNCHERS = {  # (variant, route) -> (source, symbol, argtypes)
    ("dense", "mma"): ("mx_grouped_matmul", "mx_grouped_matmul_mma_launch",
                       (_P,) * 8 + _TAIL + _MMA + (_P,)),
    ("sparse", "mma"): ("mx_grouped_matmul_sparse", "mx_grouped_matmul_sparse_mma_launch",
                        (_P,) * 10 + _TAIL + _MMA + (_P,)),
    ("abft", "mma"): ("mx_grouped_matmul_abft", "mx_grouped_matmul_abft_mma_launch",
                      (_P,) * 8 + _TAIL + _MMA + (_P,) * 4 + (_F, _F, _P)),
}


def abft_spec_for(x: torch.Tensor, w: torch.Tensor, *, inject: bool = False) -> AbftSpec:
    """The AbftSpec of a grouped launch on x (T, K) and w (G, K, N), its
    rtol from the tile the kernel launches (`_build.grouped_flag_tile`)."""
    bm, bn = _build.grouped_flag_tile(x.shape[0], w.shape[0], x.dtype, w.dtype)
    return make_abft_spec(x.dtype, w.dtype, x.shape[1], bm, bn, inject=inject)


def launch_tile(x, w, w_gate=None, w_meta=None, wg_meta=None, variant: str = "dense"):
    """(route, tile arguments) of a launch on x (T, K), w (G, K, N) or its
    2:4 payload (G, K/2, N): `_build.grouped_tile`, and the copy widths of
    x's, the weights' and the metadata's rows from their row bytes and base
    addresses (`_build.copy_width`; an expert's offset keeps its stack's
    alignment)."""
    T, K = x.shape
    G, _, N = w.shape
    t = _build.grouped_tile(T, N, K, G, x.dtype, w.dtype, w_gate is not None, variant)
    va = _build.copy_width(K * x.element_size(), x.data_ptr())
    vb = _build.copy_width(N * w.element_size(), w.data_ptr(),
                           *(() if w_gate is None else (w_gate.data_ptr(),)))
    vm = (_build.copy_width(N, *(m.data_ptr() for m in (w_meta, wg_meta) if m is not None))
          if w_meta is not None else _build.COPY_BYTES)
    return t.route, (t.bm, t.bn, t.stages, t.split, t.parts, va, vb, vm)


def _launch(x, w, w_gate, group_sizes, activation, a_scale, b_scale, bg_scale,
            out_dtype, w_meta=None, wg_meta=None, abft=None, fault=(None,) * 3):
    """Launch the dense, 2:4 sparse (w_meta given) or ABFT (abft given)
    variant on CUDA operands; returns out, or (out, flags)."""
    T, K = x.shape
    G, _, N = w.shape
    variant = "sparse" if w_meta is not None else "abft" if abft is not None else "dense"
    x_dt, w_dt = _build.pair_codes(x, w, "mx_grouped_matmul", sparse=variant == "sparse")
    _build.check_int8_k(x.dtype, w.dtype, K, "mx_grouped_matmul")
    if w_gate is not None and w_gate.dtype != w.dtype:
        raise TypeError(f"mx_grouped_matmul: w_gate dtype {w_gate.dtype} != w dtype "
                        f"{w.dtype}")
    _require_cuda_operand(x, "x", x.device)
    _require_cuda_operand(w, "w", x.device)
    if w_gate is not None:
        _require_cuda_operand(w_gate, "w_gate", x.device, tuple(w.shape))
    for t, what in ((w_meta, "w_meta"), (wg_meta, "wg_meta")):
        if t is not None:
            _require_cuda_operand(t, what, x.device, (G, K // 8, N))
    if group_sizes.device != x.device:
        raise ValueError(f"group_sizes is on {group_sizes.device}, expected {x.device}")
    scales = [_scale_vec(t, n, what, x.device) for t, n, what in (
        (a_scale, T, "a_scale"), (b_scale, G * N, "b_scale"), (bg_scale, G * N, "bg_scale"))]
    sizes = group_sizes.to(torch.int32).contiguous()
    out = torch.empty((T, N), dtype=out_dtype, device=x.device)
    flags = None
    if abft is not None:
        bm, bn = _build.grouped_flag_tile(T, G, x.dtype, w.dtype)
        flags = torch.zeros((-(-T // bm), -(-N // bn)), dtype=torch.int32, device=x.device)
    if T == 0 or N == 0:
        return out if flags is None else (out, flags)
    route, tile = launch_tile(x, w, w_gate, w_meta, wg_meta, variant)
    source, symbol, argtypes = _LAUNCHERS[variant, route]
    fn = _build.function(source, symbol, argtypes)
    head = [x.data_ptr(), w.data_ptr(), _ptr(w_gate)]
    if variant == "sparse":
        head += [w_meta.data_ptr(), _ptr(wg_meta)]
    args = [*head, *(_ptr(t) for t in scales), sizes.data_ptr(), out.data_ptr(),
            _build.dtype_code(out_dtype, "out_dtype"), T, N, K, G, x_dt, w_dt,
            ACT_CODES[activation], *tile]
    if variant == "abft":
        fd, fr, fc = _fault_operands(fault, x.device)
        args += [flags.data_ptr(), _ptr(fd), _ptr(fr), _ptr(fc), abft.rtol, abft.atol]
    err = fn(*args, _build.stream_ptr(x))
    _build.check(err, source, "mx_grouped_matmul")
    mx_grouped_matmul.launches += 1
    mx_grouped_matmul.variants[variant] += 1
    return out if flags is None else (out, flags)


def mx_grouped_matmul(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor, *,
                      w_gate: Optional[torch.Tensor] = None, activation: str = "none",
                      a_scale=None, b_scale=None, bg_scale=None, b_sparse: bool = False,
                      w_meta=None, wg_meta=None, out_dtype=None,
                      abft: Optional[AbftSpec] = None, fault_delta=None, fault_row=None,
                      fault_col=None):
    """out[t] = act(x[t] @ w[g(t)]).  x: (T, K) rows sorted by group; w:
    (G, K, N); group_sizes: (G,) ints, on x's device.  Rows at or past
    sum(group_sizes) are zero; oversubscribed sizes (sum > T) drop the rows
    that do not exist.  activation "swiglu" gates with w_gate (G, K, N):
    silu(x @ w_gate[g]) * (x @ w[g]).  Quantized payloads carry a_scale
    (T, 1) and per-expert b_scale / bg_scale (G, 1, N); bg_scale is given
    iff gated and b_scale is.  out_dtype defaults to x.dtype; pass it for
    quantized payloads.

    ``b_sparse``: w / w_gate are the per-expert 2:4 payloads (G, K/2, N),
    ``w_meta`` / ``wg_meta`` their uint8 metadata (G, K/8, N); K % 8 == 0;
    not with ``abft``.  ``abft`` (`AbftSpec`, see `abft_spec_for`): returns
    (out, flags), flags (row_tiles, col_tiles) int32 over
    `_build.grouped_flag_tile`'s tiles; ``fault_*`` of that shape iff
    ``abft.inject``.

    A CUDA `x` launches the dense, sparse or ABFT variant of the kernel (the
    operand pairs of `mx_matmul_fused`) on `mx_matmul.grouped_route`'s K
    loop; a CPU `x` takes `grouped_matmul_ref`."""
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"expected x (T, K), w (G, K, N); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    T, K = x.shape
    G, kb, N = w.shape
    fault = (fault_delta, fault_row, fault_col)
    _check_variant_args(b_sparse, w_meta, wg_meta, activation == "swiglu", abft, fault, K,
                        kb, N, (G,))
    if tuple(group_sizes.shape) != (G,):
        raise ValueError(f"group_sizes must have shape ({G},) to match w's "
                         f"leading dim; got {tuple(group_sizes.shape)}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; one of {ACTIVATIONS}")
    if (activation == "swiglu") != (w_gate is not None):
        raise ValueError("w_gate must be given iff activation=='swiglu'")
    if w_gate is not None and w_gate.shape != w.shape:
        raise ValueError(f"w_gate {tuple(w_gate.shape)} != w {tuple(w.shape)}")
    if (bg_scale is not None) != (activation == "swiglu" and b_scale is not None):
        raise ValueError("bg_scale must be given iff gated AND b_scale is set")
    for t, shape, what in ((a_scale, (T, 1), "a_scale"), (b_scale, (G, 1, N), "b_scale"),
                           (bg_scale, (G, 1, N), "bg_scale")):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{what} must be {shape}, got {tuple(t.shape)}")
    if fault_delta is not None:
        bm, bn = _build.grouped_flag_tile(T, G, x.dtype, w.dtype)
        grid = (-(-T // bm), -(-N // bn))
        for t in fault:
            if tuple(t.shape) != grid:
                raise ValueError(f"fault operand shape {tuple(t.shape)} != tile grid "
                                 f"{grid}")
    _build.refuse_grad("mx_grouped_matmul", x, w, w_gate, a_scale, b_scale, bg_scale)
    out_dtype = out_dtype or x.dtype
    kw = dict(w_gate=w_gate, activation=activation, a_scale=a_scale, b_scale=b_scale,
              bg_scale=bg_scale)
    if x.is_cuda:
        return _launch(x, w, w_gate, group_sizes, activation, a_scale, b_scale, bg_scale,
                       out_dtype, w_meta, wg_meta, abft, fault)
    return grouped_matmul_ref(x, w, group_sizes, **kw, w_meta=w_meta, wg_meta=wg_meta,
                              out_dtype=out_dtype, abft=abft, fault_delta=fault_delta,
                              fault_row=fault_row, fault_col=fault_col)


mx_grouped_matmul.launches = 0  # kernel launches (CUDA tensors only), every variant
mx_grouped_matmul.variants = {"dense": 0, "sparse": 0, "abft": 0}  # by variant
