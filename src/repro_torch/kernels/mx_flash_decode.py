"""Paged split-KV flash decode and speculative verify (port of
`repro/kernels/mx_flash_decode.py`, `mx_flash_decode` and `mx_flash_verify`).

On a CUDA tensor each wrapper launches the one kernel of
`csrc/mx_flash_decode.cu` (decode is verify at S = 1): a thread-block
cluster per (slot, kv head, window row) splits the slot's page walk into
spans of `_build.decode_span(page_size, d, page dtype)` pages, each CTA
computing the partial (m, l, acc) of its spans with positions past each
query row's last visible position masked before the max, and rank 0 folds
the partials in span order through distributed shared memory and stores
each output row once.  The bits depend on the positions, the page size and
the page dtype alone (not on the batch, the table width or the cluster
`_build.decode_split` picks), so verify at S = 1 equals decode bitwise.
On a CPU tensor it runs the plain version (`kernels.ref.paged_decode_ref` /
`paged_verify_ref`).

Both take f32 or bf16 queries and f32, bf16, int8 or fp8 (e4m3) pages; a
quantized cache passes its f32 `k_scale` / `v_scale` (P, page_size, Hkv)
scale pages, which the kernel applies to each K/V row as it stages it.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .ref import paged_decode_ref, paged_verify_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P,) * 8 + (_I,) * 9 + (_F,) + (_I,) * 4 + (_P,)
_PAGE_DTYPES = (torch.float32, torch.bfloat16, torch.int8, torch.float8_e4m3fn)


@functools.lru_cache(maxsize=None)
def _limit(symbol: str, *args) -> int:
    """A size the kernel is built with (csrc/mx_flash_decode.cu is its one
    source), read from the library."""
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
    elif k_pages.dtype in _build.QUANTIZED:
        raise ValueError(f"{what}: {k_pages.dtype} pages need k_scale / v_scale")


def _launch(wrapper, q, k_pages, v_pages, page_table, lengths, k_scale, v_scale,
            split=None):
    """Launch csrc/mx_flash_decode.cu's kernel on q (B, S, H, d) after the
    device-side checks, and count it on `wrapper`.  `split` (a
    `_build.DecodeSplit`; the on-card tests and tools/split_variants.py try
    others) defaults to `_build.decode_split`'s for the shape.  Returns the
    output (q's shape and dtype)."""
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
    B, S, H, d = q.shape
    _, ps, Hkv, _ = k_pages.shape
    W = page_table.shape[1]
    try:
        split = split or _build.decode_split(B, S, Hkv, H // Hkv, d, ps, W, k_pages.dtype,
                                             k_scale is not None)
    except ValueError as e:
        raise ValueError(f"{kernel}: {e}") from None
    out = torch.empty_like(q)
    if B == 0:
        return out
    fn = _build.function("mx_flash_decode", "mx_flash_paged_launch", _ARGTYPES)
    ks = k_scale.data_ptr() if k_scale is not None else None
    vs = v_scale.data_ptr() if v_scale is not None else None
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ks, vs,
             page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, S, H, Hkv, d, ps,
             W, dq, dp, 1.0 / math.sqrt(d), split.span_pages, split.group, split.ring,
             split.cluster, _build.stream_ptr(q))
    _build.check(err, "mx_flash_decode", f"{kernel} ({split})")
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
    GQA: query head h is served by kv head h // (H // Hkv).  An int8 or fp8
    cache passes k_scale / v_scale (P, page_size, Hkv).  G = H / Hkv past
    32, d past 256 or a page too large for a block's shared memory raises.
    Returns (B, H, d) in q's dtype."""
    _check("mx_flash_decode", q, k_pages, v_pages, page_table, lengths, k_scale, v_scale)
    _build.refuse_grad("mx_flash_decode", q, k_pages, v_pages, k_scale, v_scale)
    if not q.is_cuda:
        return paged_decode_ref(q, k_pages, v_pages, page_table, lengths,
                                k_scale=k_scale, v_scale=v_scale)
    out = _launch(mx_flash_decode, q[:, None], k_pages, v_pages, page_table, lengths,
                  k_scale, v_scale)
    return out[:, 0]


def mx_flash_verify(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    page_table: torch.Tensor, lengths: torch.Tensor, *,
                    k_scale=None, v_scale=None) -> torch.Tensor:
    """Batched-verify paged attention: S query rows per slot in one launch.

    q: (B, S, H, d), the S = k+1 speculative window per slot (its K/V rows
    already written into the pages); pages, page_table and scales as in
    `mx_flash_decode`; lengths: (B,) live token counts INCLUDING the
    window (query row r sits at position lengths[i] - S + r and attends
    positions <= its own).  lengths 0 marks a free slot, whose rows are all
    zeros.  The kernel is decode's: a page size whose one page needs more
    shared memory than a block can use raises, as do G past 32 and d past
    256.  Returns (B, S, H, d) in q's dtype."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, H, d), got {tuple(q.shape)}")
    _check("mx_flash_verify", q, k_pages, v_pages, page_table, lengths, k_scale, v_scale)
    _build.refuse_grad("mx_flash_verify", q, k_pages, v_pages, k_scale, v_scale)
    if not q.is_cuda:
        return paged_verify_ref(q, k_pages, v_pages, page_table, lengths,
                                k_scale=k_scale, v_scale=v_scale)
    return _launch(mx_flash_verify, q, k_pages, v_pages, page_table, lengths, k_scale,
                   v_scale)


mx_flash_decode.launches = 0  # kernel launches (CUDA tensors only)
mx_flash_verify.launches = 0
