"""Plain PyTorch oracles for the ported kernels (counterparts of
`repro/kernels/ref.py`).

Each `*_ref` is the semantic ground truth its CUDA kernel is held against
(tests on the CPU compare them with the JAX oracles; `chip_smoke.py` and
`tests/test_torch_cuda.py` compare the kernels with them on the card).
"""
from __future__ import annotations

import math

import torch

from ._build import grouped_flag_tile
from .mx_matmul import abft_plain, apply_activation, dot_f32
from .sparse import expand_24


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


def ssd_scan_ref(x, a_log, b, c, chunk: int = 0):
    """Mamba-2 SSD oracle: the exact sequential scan of one head.

    x: (L, P); a_log: (L,) log of the per-step decay; b, c: (L, S).
    h_t = exp(a_log_t) h_{t-1} + b_t^T x_t and y_t = c_t h_t in f32; returns
    y (L, P) in x's dtype.  `chunk` is unused: the chunked kernel and
    `ssd_scan_plain` must agree with this for every chunk size."""
    L, P = x.shape
    h = torch.zeros((b.shape[-1], P), dtype=torch.float32, device=x.device)
    xf, af, bf, cf = (t.float() for t in (x, a_log, b, c))
    ys = []
    for t in range(L):
        h = torch.exp(af[t]) * h + torch.outer(bf[t], xf[t])
        ys.append(cf[t] @ h)
    if not ys:
        return torch.zeros_like(x)
    return torch.stack(ys).to(x.dtype)


def _group_heads(t: torch.Tensor, H: int) -> torch.Tensor:
    """(B, L, G, S) -> (B, L, H, S): head h reads group h // (H / G)."""
    G = t.shape[2]
    if G == H:
        return t
    return t[:, :, torch.arange(H, device=t.device) // (H // G)]


def ssd_scan_plain(x, a_log, b, c, chunk: int = 128):
    """The plain version of the `ssd_scan` kernel: JAX's batched chunked SSD
    (`repro/models/ssm.py::ssd_chunked`'s scan body), its `lax.scan` over
    chunks written as a loop.

    x: (B, L, H, P); a_log: (B, L, H); b, c: (B, L, G, S) with G dividing H
    (head h reads group h // (H / G)).  L is padded to a multiple of
    `chunk` with a_log = 0 and b = 0, which leaves the state untouched;
    every product runs in f32.  Returns y (B, L, H, P) in x's dtype."""
    B, L, H, P = x.shape
    b, c = _group_heads(b, H), _group_heads(c, H)
    S = b.shape[-1]
    pad = (-L) % chunk
    xf, af, bf, cf = (t.float() for t in (x, a_log, b, c))
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, 0, 0, pad))
        af = torch.nn.functional.pad(af, (0, 0, 0, pad))
        bf = torch.nn.functional.pad(bf, (0, 0, 0, 0, 0, pad))
        cf = torch.nn.functional.pad(cf, (0, 0, 0, 0, 0, pad))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    tri = tri[None, :, :, None]
    h = torch.zeros((B, H, S, P), dtype=torch.float32, device=x.device)
    ys = []
    for start in range(0, L + pad, chunk):
        xq, aq, bq, cq = (t[:, start:start + chunk] for t in (xf, af, bf, cf))
        acum = torch.cumsum(aq, dim=1)  # (B, Q, H) inclusive
        # decay[t, s] = exp(acum_t - acum_s), masked before the exp
        delta = acum[:, :, None, :] - acum[:, None, :, :]  # (B, Q, Q, H)
        decay = torch.where(tri, torch.exp(torch.where(tri, delta, torch.zeros_like(delta))),
                            torch.zeros_like(delta))
        g = torch.einsum("blhs,bmhs->blmh", cq, bq)
        y = torch.einsum("blmh,bmhp->blhp", g * decay, xq)
        y = y + torch.exp(acum)[..., None] * torch.einsum("blhs,bhsp->blhp", cq, h)
        p_last = torch.exp(acum[:, -1:, :])  # (B, 1, H)
        scale = torch.exp(acum[:, -1:, :] - acum)  # (B, Q, H)
        h = p_last[:, 0, :, None, None] * h + torch.einsum(
            "blhs,blhp->bhsp", bq * scale[..., None], xq)
        ys.append(y)
    if not ys:
        return torch.zeros_like(x)
    return torch.cat(ys, dim=1)[:, :L].to(x.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, scale=None):
    """Softmax attention oracle of one head: q (Lq, d), k / v (Lk, d).  The
    causal mask is JAX's oracle's, aligned bottom-right (query i sees keys
    <= i + Lk - Lq); at Lq == Lk it is the kernel's top-left mask."""
    Lq, d = q.shape
    Lk = k.shape[0]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    s = (q.float() @ k.float().t()) * scale
    if causal:
        mask = torch.tril(torch.ones((Lq, Lk), dtype=torch.bool, device=q.device),
                          diagonal=Lk - Lq)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return (p @ v.float()).to(q.dtype)


def flash_attention_plain(q, k, v, *, causal: bool = True, bk: int = 128):
    """The plain version of the `mx_flash_attention` kernel: the online
    softmax of `repro/kernels/mx_flash_attention.py::_flash_kernel` over KV
    tiles of `bk` rows, for every (batch, head) at once.

    q: (B, Lq, H, d); k, v: (B, Lk, Hkv, d), query head h reading kv head
    h // (H / Hkv).  Scores at scale 1/sqrt(d) in f32, the causal mask
    top-left (qpos >= kpos, no offset); (m, l, acc) in f32, and the
    probabilities enter the PV product in f32 whatever v's dtype (the TPU
    kernel widens v to f32, so its `p.astype(v.dtype)` keeps p in f32); a
    row masked throughout gives 0.  Returns (B, Lq, H, d) in q's dtype."""
    B, Lq, H, d = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    heads = torch.arange(H, device=q.device) // (H // Hkv)
    qf = q.float().transpose(1, 2)                      # (B, H, Lq, d)
    kf = k.float()[:, :, heads].transpose(1, 2)         # (B, H, Lk, d)
    vf = v.float()[:, :, heads].transpose(1, 2)
    scale = 1.0 / math.sqrt(d)
    qpos = torch.arange(Lq, device=q.device)[:, None]
    m = torch.full((B, H, Lq), float("-inf"), device=q.device)
    l = torch.zeros((B, H, Lq), device=q.device)
    acc = torch.zeros((B, H, Lq, d), device=q.device)
    for k0 in range(0, Lk, bk):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k0 + bk]) * scale
        if causal:
            kpos = k0 + torch.arange(s.shape[-1], device=q.device)[None, :]
            s = s.masked_fill(~(qpos >= kpos), float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), torch.zeros_like(m))
        p = torch.exp(s - m_safe[..., None])  # masked: exp(-inf) == 0
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p, vf[:, :, k0:k0 + bk])
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def _gather_pages(pages: torch.Tensor, page_table: torch.Tensor,
                  scale=None) -> torch.Tensor:
    """(P, ps, Hkv, d) pool + (B, W) table -> (B, W*ps, Hkv, d) f32, each
    row dequantized by its (P, ps, Hkv) `scale` when one is given."""
    B, W = page_table.shape
    _, ps, Hkv, d = pages.shape
    tbl = page_table.long()
    g = pages[tbl].float()  # (B, W, ps, Hkv, d)
    if scale is not None:
        g = g * scale[tbl][..., None]
    return g.reshape(B, W * ps, Hkv, d)


def paged_decode_ref(q, k_pages, v_pages, page_table, lengths, *,
                     k_scale=None, v_scale=None):
    """Gather-based oracle for `mx_flash_decode`.

    q: (B, H, d) one token per slot; k_pages / v_pages: (P, ps, Hkv, d)
    flat page pools; page_table: (B, W) physical page ids; lengths: (B,)
    live token counts (0 = free slot -> zero output row).  Optional
    k_scale / v_scale: (P, ps, Hkv) per-row dequant scales (int8 / fp8 cache).
    """
    B, H, d = q.shape
    _, ps, Hkv, _ = k_pages.shape
    G = H // Hkv
    W = page_table.shape[1]
    lengths = lengths.to(torch.int32)
    k = _gather_pages(k_pages, page_table, k_scale)
    v = _gather_pages(v_pages, page_table, v_scale)
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


def paged_prefill_ref(q, k_pages, v_pages, page_table, index, *,
                      k_scale=None, v_scale=None):
    """Multi-query sibling of `paged_decode_ref`: causal attention of S
    query tokens at positions [index, index+S) over a paged KV cache whose
    pages already hold every position <= the query's own.

    q: (B, S, H, d); page_table: (B, W); index: (B,) each slot's chunk
    start position; k_scale / v_scale as in `paged_decode_ref`.  Query j
    of slot b attends over kpos <= index[b] + j.
    """
    B, S, H, d = q.shape
    _, ps, Hkv, _ = k_pages.shape
    G = H // Hkv
    W = page_table.shape[1]
    k = _gather_pages(k_pages, page_table, k_scale)
    v = _gather_pages(v_pages, page_table, v_scale)
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


def paged_verify_ref(q, k_pages, v_pages, page_table, lengths, *,
                     k_scale=None, v_scale=None):
    """Oracle for `mx_flash_verify`: S = k+1 window rows per slot whose
    lengths INCLUDE the window, so row r sits at position lengths - S + r.
    It is `paged_prefill_ref` at index = lengths - S with the rows of free
    slots (length 0) set to exact zeros, where the prefill oracle's empty
    softmax gives NaN (`repro/models/layers.py` inlines the same).
    q: (B, S, H, d); the rest as in `paged_decode_ref`."""
    S = q.shape[1]
    lengths = torch.as_tensor(lengths, device=q.device).to(torch.int64)
    o = paged_prefill_ref(q, k_pages, v_pages, page_table, lengths - S,
                          k_scale=k_scale, v_scale=v_scale)
    return torch.where((lengths > 0)[:, None, None, None], o,
                       torch.zeros((), dtype=o.dtype, device=o.device))


def _group_epilogue(h, gate, a_s, b_s, bg_s, activation):
    """A group's f32 product through the kernel's store: acc * a_scale *
    b_scale[g] (the gate likewise with bg_scale), then the activation."""
    if a_s is not None:
        h = h * a_s
    if b_s is not None:
        h = h * b_s
    if activation != "swiglu":
        return apply_activation(h, activation)
    if a_s is not None:
        gate = gate * a_s
    if bg_s is not None:
        gate = gate * bg_s
    return torch.nn.functional.silu(gate) * h


def _group_spans(group_sizes, T):
    """(group, first row, end row) of every non-empty group, clamped to T, a
    negative size as 0 -- the kernel's reading of the sizes."""
    spans, start = [], 0
    for g, n in enumerate(torch.as_tensor(group_sizes).tolist()):
        end = min(start + max(n, 0), T)
        if end > start:
            spans.append((g, start, end))
        start = end
    return spans


def _grouped_flags(x, w, wd, spans, spec, faults):
    """JAX's per-expert checksums over the grouped kernel's tiles
    (`_build.grouped_flag_tile`): every visit of a row tile by an overlapping
    group verifies that group's accumulator (the tile's rows of x past the
    group's end are zero, as the kernel reads them), the verdicts OR-ed into
    the tile's flag; a tile no group covers keeps flag 0.  `wd(g)` is
    expert g's dense weight, `faults` (tile -> (row, col, delta))."""
    T, K = x.shape
    G, N = w.shape[0], w.shape[-1]
    bm, bn = grouped_flag_tile(T, G, x.dtype, w.dtype)
    gm, gn = -(-T // bm), -(-N // bn)
    flags = torch.zeros((gm, gn), dtype=torch.int32, device=x.device)
    for g, s, e in spans:
        wg = wd(g)
        for t in range(s // bm, (e - 1) // bm + 1):
            m0 = t * bm
            xs = x[m0:min(m0 + bm, e)]
            fd = torch.zeros((1, gn), dtype=torch.float32)
            fr = torch.zeros((1, gn), dtype=torch.int32)
            fc = torch.zeros((1, gn), dtype=torch.int32)
            for (ti, tj), (r, c, d) in faults.items():
                if ti == t:
                    fd[0, tj], fr[0, tj], fc[0, tj] = d, r, c
            # one visit = a (bm, K) x (K, N) product over this row tile
            xs = torch.nn.functional.pad(xs, (0, 0, 0, bm - xs.shape[0]))
            _, f = abft_plain(xs, wg, dot_f32(xs, wg), spec, bm, bn, fd, fr, fc)
            flags[t] |= f[0].to(flags.device)
    return flags


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor, group_sizes, *,
                       w_gate=None, activation: str = "none", a_scale=None,
                       b_scale=None, bg_scale=None, w_meta=None, wg_meta=None,
                       out_dtype=None, abft=None, fault_delta=None, fault_row=None,
                       fault_col=None):
    """Oracle for `mx_grouped_matmul` (port of `grouped_matmul_reference`
    and `_ragged_dot_f32`): out[t] = act(x[t] @ w[g(t)]) for rows sorted by
    group, swiglu as silu(x @ w_gate[g]) * (x @ w[g]), accumulated as
    `dot_f32` does (f32; exact for int8 x int8), cast to out_dtype at the
    end.  x: (T, K); w, w_gate: (G, K, N); group_sizes: (G,) ints, group g
    owning the next group_sizes[g] rows.

    Quantized payloads carry per-row ``a_scale`` (T, 1) and per-expert
    ``b_scale`` / ``bg_scale`` (G, 1, N), applied to each group's product
    in the kernel's order: acc * a_scale * b_scale[g] (the gate likewise
    with bg_scale), then the activation.  Only one expert's weights are
    widened (or, with ``w_meta`` / ``wg_meta`` (G, K/8, N), expanded from
    the 2:4 payloads (G, K/2, N)) at a time (grok's (8, 6144, 32768) int8
    stack would be 6.4 GB in f32).

    With ``abft`` (an AbftSpec) it returns (out, flags), the flag map of
    the grouped kernel's tiles (`_grouped_flags`); the fault operands
    (row_tiles, col_tiles) add their delta to the accumulator element they
    name, in the output too where a group owns that row.

    Group ranges are clamped to T (oversubscribed sizes drop the rows that
    do not exist, as the TPU kernel clamps to its padded rows) and a
    negative size counts as 0, the kernel's reading; rows at or past
    sum(sizes) are exact zeros.  The sizes are read on the host, one dense
    GEMM per non-empty group: an empty group reads none of its weights."""
    T = x.shape[0]
    N = w.shape[-1]

    def dense(stack, meta, g):
        return stack[g] if meta is None else expand_24(stack[g], meta[g])

    faults = {}
    if fault_delta is not None:
        bm, bn = grouped_flag_tile(T, w.shape[0], x.dtype, w.dtype)
        for ti, tj in torch.nonzero(fault_delta != 0).tolist():
            faults[(ti, tj)] = (int(fault_row[ti, tj]), int(fault_col[ti, tj]),
                                float(fault_delta[ti, tj]))
    out = torch.zeros((T, N), dtype=torch.float32, device=x.device)
    spans = _group_spans(group_sizes, T)
    for g, start, end in spans:
        xs = x[start:end]
        wg = dense(w, w_meta, g)
        h = dot_f32(xs, wg)
        exact = abft is not None and abft.exact
        for (ti, tj), (r, c, d) in faults.items():
            row, col = ti * bm + r, tj * bn + c
            if not (start <= row < end and col < N):
                continue  # no output row of this group: only the flag sees it
            if exact:  # the int32 accumulator plus an integer delta, then widened
                acc = torch.dot(x[row].double(), wg[:, col].double()) + float(int(d))
                h[row - start, col] = acc.float()
            else:
                h[row - start, col] += d
        gate = dot_f32(xs, dense(w_gate, wg_meta, g)) if activation == "swiglu" else None
        out[start:end] = _group_epilogue(
            h, gate, None if a_scale is None else a_scale[start:end],
            None if b_scale is None else b_scale[g], None if bg_scale is None else bg_scale[g],
            activation)
    out = out.to(out_dtype or x.dtype)
    if abft is None:
        return out
    return out, _grouped_flags(x, w, lambda g: dense(w, w_meta, g), spans, abft, faults)
