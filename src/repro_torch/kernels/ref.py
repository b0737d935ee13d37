"""Plain PyTorch oracles for the ported kernels (counterparts of
`repro/kernels/ref.py`).

Each `*_ref` is the semantic ground truth its CUDA kernel is held against
(tests on the CPU compare them with the JAX oracles; `chip_smoke.py` and
`tests/test_torch_cuda.py` compare the kernels with them on the card).
"""
from __future__ import annotations

import math

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """D = A @ B with f32 accumulation (the MX semantic: full-precision
    accumulation in the near-FPU buffer, single write-back)."""
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def baseline_matmul_ref(a: torch.Tensor, b: torch.Tensor, bk: int,
                        out_dtype=None) -> torch.Tensor:
    """Oracle for the *baseline* kernel: partial sums round-trip through the
    output buffer in the output dtype every bk-chunk (no inter-k buffering).
    For f32 outputs this equals matmul_ref; for narrow dtypes it exposes the
    accumulation-precision loss the MX buffer avoids."""
    out_dtype = out_dtype or a.dtype
    K = a.shape[-1]
    nk = -(-K // bk)
    out = torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=out_dtype,
                      device=a.device)
    for ki in range(nk):
        a_blk = a[..., ki * bk:(ki + 1) * bk].float()
        b_blk = b[ki * bk:(ki + 1) * bk, :].float()
        out = (out.float() + torch.matmul(a_blk, b_blk)).to(out_dtype)
    return out


def _gather_pages(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """(P, ps, Hkv, d) pool + (B, W) table -> (B, W*ps, Hkv, d) f32."""
    B, W = page_table.shape
    _, ps, Hkv, d = pages.shape
    g = pages[page_table.long()].float()  # (B, W, ps, Hkv, d)
    return g.reshape(B, W * ps, Hkv, d)


def paged_decode_ref(q, k_pages, v_pages, page_table, lengths):
    """Gather-based oracle for `mx_flash_decode`.

    q: (B, H, d) one token per slot; k_pages / v_pages: (P, ps, Hkv, d)
    flat page pools; page_table: (B, W) physical page ids; lengths: (B,)
    live token counts (0 = free slot -> zero output row).
    """
    B, H, d = q.shape
    _, ps, Hkv, _ = k_pages.shape
    G = H // Hkv
    W = page_table.shape[1]
    lengths = lengths.to(torch.int32)
    k = _gather_pages(k_pages, page_table)
    v = _gather_pages(v_pages, page_table)
    qh = q.float().reshape(B, Hkv, G, d)
    s = torch.einsum("bhgd,bshd->bhgs", qh, k) / math.sqrt(d)
    kpos = torch.arange(W * ps, device=q.device)[None, None, None, :]
    # free slots (length 0) attend to position 0 so the softmax stays
    # defined; their rows are zeroed below (matching the kernel's output)
    keep = kpos < torch.clamp(lengths, min=1)[:, None, None, None]
    s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v)
    o = torch.where((lengths > 0)[:, None, None, None], o,
                    torch.zeros((), dtype=o.dtype, device=o.device))
    return o.reshape(B, H, d).to(q.dtype)


def paged_prefill_ref(q, k_pages, v_pages, page_table, index):
    """Multi-query sibling of `paged_decode_ref`: causal attention of S
    query tokens at positions [index, index+S) over a paged KV cache whose
    pages already hold every position <= the query's own.

    q: (B, S, H, d); page_table: (B, W); index: (B,) each slot's chunk
    start position.  Query j of slot b attends over kpos <= index[b] + j.
    """
    B, S, H, d = q.shape
    _, ps, Hkv, _ = k_pages.shape
    G = H // Hkv
    W = page_table.shape[1]
    k = _gather_pages(k_pages, page_table)
    v = _gather_pages(v_pages, page_table)
    qh = q.float().reshape(B, S, Hkv, G, d)
    s = torch.einsum("bqhgd,bshd->bhgqs", qh, k) / math.sqrt(d)
    index = torch.as_tensor(index, device=q.device).to(torch.int64)
    qpos = index[:, None] + torch.arange(S, device=q.device)  # (B, S)
    kpos = torch.arange(W * ps, device=q.device)
    keep = kpos[None, None, :] <= qpos[:, :, None]              # (B, S, W*ps)
    s = s.masked_fill(~keep[:, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqs,bshd->bqhgd", p, v)
    return o.reshape(B, S, H, d).to(q.dtype)
