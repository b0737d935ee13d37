"""Chunked Mamba-2 SSD scan (port of `repro/kernels/ssd_scan.py::ssd_scan`).

On a CUDA tensor the wrapper launches `csrc/ssd_scan.cu`: one CTA per
(sequence, head) loops over the chunks inside the kernel, runs each
chunk's four products on the tensor cores (3xTF32 in f32; the lower
triangles of the Q x Q products only) with the next chunk's copies in
flight (`_build.ssd_tile`), and keeps the (S, P) f32 state in shared
memory across the loop, never storing it; b and c are read per group.  On
a CPU tensor it runs the plain version (`kernels.ref.ssd_scan_plain`, the
chunked einsum form of `repro/models/ssm.py::ssd_chunked`).

It takes the batched layout `ssd_chunked` uses -- x (B, L, H, P), a_log
(B, L, H), b and c (B, L, G, S) with G dividing H -- or one head as JAX's
kernel does: x (L, P), a_log (L,), b and c (L, S).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import ssd_scan_plain

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 5 + (_I,) * 9 + (_P,)


def _check(x, a_log, b, c):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, L, H, P) or (L, P), got {tuple(x.shape)}")
    B, L, H, _ = x.shape
    if a_log.shape != (B, L, H):
        raise ValueError(f"a_log must be {(B, L, H)}, got {tuple(a_log.shape)}")
    if b.dim() != 4 or b.shape[:2] != (B, L) or c.shape != b.shape:
        raise ValueError(f"b / c must be (B, L, G, S) with (B, L) = {(B, L)}, got "
                         f"{tuple(b.shape)} / {tuple(c.shape)}")
    if H % b.shape[2]:
        raise ValueError(f"H={H} is not a multiple of the groups G={b.shape[2]}")


def ssd_scan(x: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
             chunk: int = 128) -> torch.Tensor:
    """SSD scan h_t = exp(a_log_t) h_{t-1} + b_t^T x_t, y_t = c_t h_t per
    (sequence, head), chunk by chunk (L padded to a multiple of `chunk`
    with a_log = 0 and b = 0).  Shapes in the module docstring; a_log is
    f32, x, b and c f32 or bf16 of one dtype; returns y in x's shape and
    dtype."""
    single = x.dim() == 2
    if single:
        x, a_log, b, c = x[None, :, None], a_log[None, :, None], b[None, :, None], c[None, :, None]
    _check(x, a_log, b, c)
    _build.refuse_grad("ssd_scan", x, a_log, b, c)
    if not x.is_cuda:
        y = ssd_scan_plain(x, a_log, b, c, chunk)
        return y[0, :, 0] if single else y
    B, L, H, P = x.shape
    G, S = b.shape[2], b.shape[3]
    dt = _build.dtype_code(x.dtype, "ssd_scan x")
    for t, what in ((b, "b"), (c, "c")):
        if t.dtype != x.dtype:
            raise TypeError(f"ssd_scan: {what} is {t.dtype}, x is {x.dtype}")
    if a_log.dtype != torch.float32:
        raise TypeError(f"ssd_scan: a_log must be float32, got {a_log.dtype}")
    for t, what in ((x, "x"), (a_log, "a_log"), (b, "b"), (c, "c")):
        if t.device != x.device:
            raise ValueError(f"{what} is on {t.device}, expected {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {what} must be contiguous")
    y = torch.empty_like(x)
    if B * L * H == 0:
        return y[0, :, 0] if single else y
    tile = _build.ssd_tile(chunk, P, S, x.dtype)
    fn = _build.function("ssd_scan", "ssd_scan_launch", _ARGTYPES)
    err = fn(x.data_ptr(), a_log.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
             B, L, H, G, P, S, chunk, dt, tile.stages, _build.stream_ptr(x))
    _build.check(err, "ssd_scan", f"ssd_scan at chunk={chunk}, P={P}, S={S} ({tile})")
    ssd_scan.launches += 1
    return y[0, :, 0] if single else y


ssd_scan.launches = 0  # kernel launches (CUDA tensors only)
