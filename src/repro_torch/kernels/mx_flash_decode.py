"""Paged split-KV flash decode and speculative verify (port of
`repro/kernels/mx_flash_decode.py`, `mx_flash_decode` and `mx_flash_verify`).

On a CUDA tensor each wrapper launches its kernel in
`csrc/mx_flash_decode.cu`: one CTA per (slot, kv head) walks the slot's page
table, masks positions past each query row's last visible position before
the running max, keeps (m, l, acc) in f32 and stores each output row once.
On a CPU tensor it runs the plain version (`kernels.ref.paged_decode_ref` /
`paged_verify_ref`).

Both take f32 or bf16 queries and f32, bf16 or int8 pages; an int8 cache
passes its f32 `k_scale` / `v_scale` (P, page_size, Hkv) scale pages, which
the kernels apply to each K/V row as they stage it.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .ref import paged_decode_ref, paged_verify_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DECODE_ARGTYPES = (_P,) * 8 + (_I,) * 8 + (_F, _P)
_VERIFY_ARGTYPES = (_P,) * 8 + (_I,) * 9 + (_F, _P)
_PAGE_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


@functools.lru_cache(maxsize=None)
def _limit(symbol: str, *args) -> int:
    """A size the kernels are built with (csrc/mx_flash_decode.cu is their
    one source), read from the library."""
    return _build.function("mx_flash_decode", symbol, (_I,) * len(args),
                           restype=ctypes.c_size_t)(*args)


def _check(what, q, k_pages, v_pages, page_table, lengths, k_scale, v_scale):
    """Shapes, dtypes and scale pages shared by both wrappers; q is
    (B, [S,] H, d)."""
    B, H, d = q.shape[0], q.shape[-2], q.shape[-1]
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
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    if k_scale is not None:
        for t, name in ((k_scale, "k_scale"), (v_scale, "v_scale")):
            if t.shape != (P, ps, Hkv):
                raise ValueError(f"{name} must be (P, ps, Hkv)={(P, ps, Hkv)}, "
                                 f"got {tuple(t.shape)}")
    elif k_pages.dtype == torch.int8:
        raise ValueError(f"{what}: int8 pages need k_scale / v_scale")


def _launch(wrapper, symbol, argtypes, q, k_pages, v_pages, page_table, lengths,
            k_scale, v_scale, dims):
    """Launch `symbol` of csrc/mx_flash_decode.cu after the device-side
    checks, and count it on `wrapper`; `dims` are the shape ints between
    the pointers and the dtype codes.  Returns the output (q's shape and
    dtype)."""
    kernel = wrapper.__name__
    dq = _build.dtype_code(q.dtype, f"{kernel} q")
    dp = _build.dtype_code(k_pages.dtype, f"{kernel} pages", _PAGE_DTYPES)
    if v_pages.dtype != k_pages.dtype:
        raise TypeError(f"{kernel}: k_pages {k_pages.dtype} != v_pages {v_pages.dtype}")
    tensors = [(q, "q"), (k_pages, "k_pages"), (v_pages, "v_pages"),
               (page_table, "page_table"), (lengths, "lengths")]
    if k_scale is not None:
        tensors += [(k_scale, "k_scale"), (v_scale, "v_scale")]
        for t, what in tensors[-2:]:
            if t.dtype != torch.float32:
                raise TypeError(f"{kernel}: {what} must be float32, got {t.dtype}")
    for t, what in tensors:
        if t.device != q.device:
            raise ValueError(f"{what} is on {t.device}, expected {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {what} must be contiguous")
    for t, what in ((page_table, "page_table"), (lengths, "lengths")):
        if t.dtype != torch.int32:
            raise TypeError(f"{kernel}: {what} must be int32, got {t.dtype}")
    out = torch.empty_like(q)
    if q.shape[0] == 0:
        return out
    fn = _build.function("mx_flash_decode", symbol, argtypes)
    ks = k_scale.data_ptr() if k_scale is not None else None
    vs = v_scale.data_ptr() if v_scale is not None else None
    d = q.shape[-1]
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ks, vs,
             page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), *dims,
             dq, dp, 1.0 / math.sqrt(d), _build.stream_ptr(q))
    _build.check(err, "mx_flash_decode", kernel)
    wrapper.launches += 1
    return out


def mx_flash_decode(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    page_table: torch.Tensor, lengths: torch.Tensor, *,
                    k_scale=None, v_scale=None) -> torch.Tensor:
    """Paged flash decode.  q: (B, H, d) one token per slot; k_pages /
    v_pages: (P, page_size, Hkv, d) flat page pools; page_table: (B, W)
    int32 physical page ids (entries past a slot's pages must still be
    valid ids -- the allocator pads with its dump page); lengths: (B,) live
    token counts; 0 marks a free slot, whose output row is all zeros.
    GQA: query head h is served by kv head h // (H // Hkv).  An int8 cache
    passes k_scale / v_scale (P, page_size, Hkv).  Returns (B, H, d) in
    q's dtype."""
    _check("mx_flash_decode", q, k_pages, v_pages, page_table, lengths, k_scale, v_scale)
    if not q.is_cuda:
        return paged_decode_ref(q, k_pages, v_pages, page_table, lengths,
                                k_scale=k_scale, v_scale=v_scale)
    B, H, d = q.shape
    _, ps, Hkv, _ = k_pages.shape
    cap = _limit("mx_flash_decode_max_group_width")
    if (H // Hkv) * d > cap:
        raise ValueError(f"mx_flash_decode: G*d = {(H // Hkv) * d} exceeds the "
                         f"kernel's register accumulator of {cap} floats")
    return _launch(mx_flash_decode, "mx_flash_decode_launch", _DECODE_ARGTYPES,
                   q, k_pages, v_pages, page_table, lengths, k_scale, v_scale,
                   (B, H, Hkv, d, ps, page_table.shape[1]))


def mx_flash_verify(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    page_table: torch.Tensor, lengths: torch.Tensor, *,
                    k_scale=None, v_scale=None) -> torch.Tensor:
    """Batched-verify paged attention: S query rows per slot in one launch.

    q: (B, S, H, d), the S = k+1 speculative window per slot (its K/V rows
    already written into the pages); pages, page_table and scales as in
    `mx_flash_decode`; lengths: (B,) live token counts INCLUDING the window
    (query row r sits at position lengths[i] - S + r and attends positions
    <= its own).  lengths 0 marks a free slot, whose rows are all zeros.
    q and the (S*G, d) accumulator live in shared memory: a shape that
    needs more than a block can use raises.  Returns (B, S, H, d) in q's
    dtype."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, H, d), got {tuple(q.shape)}")
    _check("mx_flash_verify", q, k_pages, v_pages, page_table, lengths, k_scale, v_scale)
    if not q.is_cuda:
        return paged_verify_ref(q, k_pages, v_pages, page_table, lengths,
                                k_scale=k_scale, v_scale=v_scale)
    B, S, H, d = q.shape
    _, ps, Hkv, _ = k_pages.shape
    smem = _limit("mx_flash_verify_smem_bytes", S, H // Hkv, d, ps)
    limit = _limit("mx_flash_max_smem_bytes")
    if smem > limit:
        raise ValueError(
            f"mx_flash_verify: S={S}, G={H // Hkv}, d={d}, page_size={ps} needs "
            f"{smem} bytes of shared memory, past the {limit} a block can use")
    return _launch(mx_flash_verify, "mx_flash_verify_launch", _VERIFY_ARGTYPES,
                   q, k_pages, v_pages, page_table, lengths, k_scale, v_scale,
                   (B, S, H, Hkv, d, ps, page_table.shape[1]))


mx_flash_decode.launches = 0  # kernel launches (CUDA tensors only)
mx_flash_verify.launches = 0
