"""Baseline (non-MX) GEMM: the paper's vector-baseline traffic pattern
(port of `repro/kernels/baseline_matmul.py`).

No inter-k buffering: the partial sum of every bk-wide K chunk is added
into the output tile in the output dtype, read back and written again on
every chunk.  On a CUDA tensor `baseline_matmul` launches
`csrc/baseline_matmul.cu` (the MX kernel's tiles and K loops: at M <= 16
`_build.decode_tile`'s, above it `_build.prefill_tile`'s tensor-core loop
with one CTA per tile); on a CPU tensor it runs the plain version
(`kernels.ref.baseline_matmul_ref`, the same per-chunk rounding).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .mx_matmul import decode_launch_tile, prefill_launch_tile
from .ref import baseline_matmul_ref

KERNEL_BK = 128  # the CUDA kernels' K step between round trips; bk must be a multiple

_P, _I = ctypes.c_void_p, ctypes.c_int
_HEAD = (_P, _P, _P, _I, _I, _I, _I, _I, _I)  # a, b, out, out_dt, M, N, K, in_dt, bk
# the prefill rows: the prefill tile (bm, bn, stages, va, vb); the decode
# rows: the decode tile (bn, bk, tm, stages, threads, va, vb)
_ARGTYPES = _HEAD + (_I,) * 5 + (_P,)
_DECODE_ARGTYPES = _HEAD + (_I,) * 7 + (_P,)


def _launch(a, b, bk, out_dtype):
    M, K = a.shape
    N = b.shape[1]
    dt = _build.dtype_code(a.dtype, "baseline_matmul operands")
    if b.dtype != a.dtype:
        raise TypeError(f"baseline_matmul: b dtype {b.dtype} != a dtype {a.dtype}")
    if b.device != a.device:
        raise ValueError(f"b is on {b.device}, expected {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("baseline_matmul operands must be contiguous")
    if bk % KERNEL_BK:
        raise ValueError(f"the CUDA baseline kernel reads back its output every "
                         f"bk columns of K; bk must be a multiple of {KERNEL_BK}, "
                         f"got {bk}")
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    args = [a.data_ptr(), b.data_ptr(), out.data_ptr(),
            _build.dtype_code(out_dtype, "out_dtype"), M, N, K, dt, bk]
    decode = M <= _build.DECODE_MAX_M
    if decode:  # the MX kernel's decode tile and loop
        fn = _build.function("baseline_matmul", "baseline_matmul_decode_launch",
                             _DECODE_ARGTYPES)
        args += decode_launch_tile(a, b)
    else:  # the prefill tile's loop, one CTA per tile (no K split)
        fn = _build.function("baseline_matmul", "baseline_matmul_launch", _ARGTYPES)
        bm, bn, stages, _, _, va, vb, _ = prefill_launch_tile(a, b, variant="baseline")
        args += [bm, bn, stages, va, vb]
    err = fn(*args, _build.stream_ptr(a))
    _build.check(err, "baseline_matmul", "baseline_matmul")
    baseline_matmul.launches += 1
    baseline_matmul.decode_launches += decode
    baseline_matmul.prefill_launches += not decode
    return out


def baseline_matmul(a: torch.Tensor, b: torch.Tensor, *, bk: int = 128,
                    out_dtype=None) -> torch.Tensor:
    """D = A @ B with the partial sum living in the output, rounded to
    out_dtype after every bk-wide chunk of K.  a: (M, K), b: (K, N)."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"baseline_matmul expects 2-D operands, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    _build.refuse_grad("baseline_matmul", a, b)
    out_dtype = out_dtype or a.dtype
    if a.is_cuda:
        return _launch(a, b, bk, out_dtype)
    return baseline_matmul_ref(a, b, bk, out_dtype)


baseline_matmul.launches = 0  # kernel launches (CUDA tensors only)
baseline_matmul.decode_launches = 0  # of them, those on the decode tile (M <= 16)
baseline_matmul.prefill_launches = 0  # of them, those on the prefill tile (M > 16)
