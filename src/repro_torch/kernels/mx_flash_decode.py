"""Paged split-KV flash decode (port of `repro/kernels/mx_flash_decode.py`,
`mx_flash_decode`).

On a CUDA tensor `mx_flash_decode` launches `csrc/mx_flash_decode.cu`: one
CTA per (slot, kv head) walks the slot's page table, masks positions at or
past the slot's length before the running max, keeps (m, l, acc) in f32 and
stores each output row once.  On a CPU tensor it runs the plain version
`kernels.ref.paged_decode_ref`.

Not ported yet: int8 scale pages (`k_scale` / `v_scale`, ROADMAP queue 2
item 3 with queue 1 item 8) and the speculative-window `mx_flash_verify`
(queue 2 item 4).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import paged_decode_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P)
MAX_GROUP_WIDTH = 128 * 16  # G * d the kernel's register accumulator holds


def _launch(q, k_pages, v_pages, page_table, lengths):
    B, H, d = q.shape
    P, ps, Hkv, _ = k_pages.shape
    W = page_table.shape[1]
    G = H // Hkv
    dt = _build.dtype_code(q.dtype, "mx_flash_decode q")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"mx_flash_decode: pages {k_pages.dtype}/{v_pages.dtype} "
                        f"must match q {q.dtype}")
    if G * d > MAX_GROUP_WIDTH:
        raise ValueError(f"G*d = {G * d} exceeds the kernel's {MAX_GROUP_WIDTH}")
    for t, what in ((q, "q"), (k_pages, "k_pages"), (v_pages, "v_pages"),
                    (page_table, "page_table"), (lengths, "lengths")):
        if t.device != q.device:
            raise ValueError(f"{what} is on {t.device}, expected {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"mx_flash_decode: {what} must be contiguous")
    for t, what in ((page_table, "page_table"), (lengths, "lengths")):
        if t.dtype != torch.int32:
            raise TypeError(f"mx_flash_decode: {what} must be int32, got {t.dtype}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    fn = _build.function("mx_flash_decode", "mx_flash_decode_launch", _ARGTYPES)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             B, H, Hkv, d, ps, W, dt, 1.0 / math.sqrt(d), _build.stream_ptr(q))
    _build.check(err, "mx_flash_decode", "mx_flash_decode")
    mx_flash_decode.launches += 1
    return out


def mx_flash_decode(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    page_table: torch.Tensor, lengths: torch.Tensor, *,
                    k_scale=None, v_scale=None) -> torch.Tensor:
    """Paged flash decode.  q: (B, H, d) one token per slot; k_pages /
    v_pages: (P, page_size, Hkv, d) flat page pools; page_table: (B, W)
    int32 physical page ids (entries past a slot's pages must still be
    valid ids -- the allocator pads with its dump page); lengths: (B,) live
    token counts; 0 marks a free slot, whose output row is all zeros.
    GQA: query head h is served by kv head h // (H // Hkv).  Returns
    (B, H, d) in q's dtype."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "int8 KV scale pages are not ported yet: ROADMAP queue 2 item 3 "
            "(scales) with queue 1 item 8 (quantization)")
    B, H, d = q.shape
    P, ps, Hkv, d2 = k_pages.shape
    if d2 != d or v_pages.shape != k_pages.shape:
        raise ValueError(f"q {tuple(q.shape)} vs pages {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)}")
    if H % Hkv:
        raise ValueError(f"H={H} not a multiple of Hkv={Hkv}")
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"page_table must be (B, W), got {tuple(page_table.shape)}")
    if lengths.shape != (B,):
        raise ValueError(f"lengths must be ({B},), got {tuple(lengths.shape)}")
    if q.is_cuda:
        return _launch(q, k_pages, v_pages, page_table, lengths)
    return paged_decode_ref(q, k_pages, v_pages, page_table, lengths)


mx_flash_decode.launches = 0  # kernel launches (CUDA tensors only)
