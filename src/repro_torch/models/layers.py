"""Transformer building blocks (port of `repro/models/layers.py`, the
dense and paged-serving subset): norms, RoPE, linear, embedding, GQA
attention (full, chunked, and over a paged KV cache), MLP.

All weight-times-activation contractions route through `core.ops.linear`
(the MX dispatch); paged decode attention through `mx_flash_decode`, the
speculative window through `mx_flash_verify`.  The tied LM head, the full
and chunked attention of the full forward and the paged prefill attention
stay plain PyTorch, as they stay outside any Pallas kernel in JAX.  An
int8 KV cache quantizes each K/V row on write (per row and head) and the
attention dequantizes on read.

Not ported yet: the dense (non-paged) cache path (`Attention.decode`,
`prefill`) and fp8 KV pages.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..core import ops
from ..core.precision import QuantSpec
from ..kernels.mx_flash_decode import mx_flash_decode, mx_flash_verify
from ..kernels.quant import quantize
from ..kernels.ref import paged_decode_ref, paged_prefill_ref, paged_verify_ref
from .modules import Builder, Module


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.float()).to(dt)


def rope_freqs(head_dim: int, theta: float = 1e4, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (torch.tensor(theta, dtype=torch.float32, device=device) ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Rotates the
    split halves (not interleaved pairs), angles in f32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    angles = positions[..., :, None].float() * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class Linear(Module):
    d_in: int
    d_out: int
    bias: bool = False
    tp_mode: Optional[str] = None
    precision: Optional[str] = None

    def build(self, mk: Builder):
        p = {"w": mk.param("w", (self.d_in, self.d_out))}
        if self.bias:
            p["b"] = mk.param("b", (self.d_out,), init="zeros")
        return p

    def __call__(self, p, x):
        return ops.linear(x, p["w"], p["b"] if self.bias else None,
                          out_dtype=x.dtype, tp_mode=self.tp_mode,
                          precision=self.precision)


@dataclasses.dataclass(frozen=True)
class Embedding(Module):
    vocab: int
    d: int

    def build(self, mk: Builder):
        return {"table": mk.param("table", (self.vocab, self.d), scale=0.02)}

    def __call__(self, p, ids):
        return p["table"][ids]

    def attend(self, p, x):
        """Tied LM head: logits = x @ table^T in f32 (plain PyTorch, as JAX
        keeps it on jnp.dot outside the MX kernels)."""
        table = p["table"]
        if x.dtype == torch.float32 and table.dtype == torch.float32:
            return torch.matmul(x, table.t())
        return torch.matmul(x.float(), table.float().t())


# ---------------------------------------------------------------------------
# Attention (GQA): full, chunked (long sequences), and paged
# ---------------------------------------------------------------------------


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv*groups, D)."""
    if groups == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, groups, d).reshape(b, s, h * groups, d)


def full_attention(q, k, v, *, causal: bool, q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D), k/v: (B, Sk, H, D).  Materializes the (Sq, Sk)
    scores in f32; the probabilities are cast to q's dtype before the PV
    product, as in JAX."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(~(qpos >= kpos), float("-inf"))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def chunked_attention(q, k, v, *, causal: bool, block_kv: int = 512,
                      q_offset: int = 0) -> torch.Tensor:
    """Flash-style online-softmax attention over KV blocks of `block_kv`
    (JAX's `lax.scan` becomes a Python loop): the (m, l, o) running
    statistics stay in f32 and each KV block is read once.  A block that is
    masked throughout keeps m at -inf; the guard below keeps it out."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    m = torch.full((b, h, sq), float("-inf"), device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    o = torch.zeros((b, h, sq, d), device=q.device)
    for start in range(0, sk, block_kv):
        kblk, vblk = k[:, start:start + block_kv], v[:, start:start + block_kv]
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kblk.float()) * scale
        if causal:
            kpos = start + torch.arange(kblk.shape[1], device=q.device)[None, :]
            s = s.masked_fill(~(qpos >= kpos), float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked blocks: m_new may still be -inf
        m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), torch.zeros_like(m))
        p = torch.exp(s - m_safe[..., None])  # exp(-inf - finite) == 0 for masked
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(q.dtype).float(), vblk.float())
        m = m_new
    o = o / torch.clamp(l[..., None], min=1e-30)
    return o.transpose(1, 2).to(q.dtype)


@dataclasses.dataclass(frozen=True)
class Attention(Module):
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 1e4
    causal: bool = True
    chunked_threshold: int = 2048  # online-softmax attention beyond this
    use_rope: bool = True
    precision: Optional[str] = None

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def build(self, mk: Builder):
        hd = self.hd
        p = {
            "wq": mk.param("wq", (self.d_model, self.n_heads * hd)),
            "wk": mk.param("wk", (self.d_model, self.n_kv_heads * hd)),
            "wv": mk.param("wv", (self.d_model, self.n_kv_heads * hd)),
            "wo": mk.param("wo", (self.n_heads * hd, self.d_model)),
        }
        if self.qkv_bias:
            p["bq"] = mk.param("bq", (self.n_heads * hd,), init="zeros")
            p["bk"] = mk.param("bk", (self.n_kv_heads * hd,), init="zeros")
            p["bv"] = mk.param("bv", (self.n_kv_heads * hd,), init="zeros")
        return p

    def _qkv(self, p, x, positions):
        b, s, _ = x.shape
        hd = self.hd
        bq = p["bq"] if self.qkv_bias else None
        bk = p["bk"] if self.qkv_bias else None
        bv = p["bv"] if self.qkv_bias else None
        q = ops.linear(x, p["wq"], bq, out_dtype=x.dtype, tp_mode="allgather",
                       precision=self.precision)
        k = ops.linear(x, p["wk"], bk, out_dtype=x.dtype, tp_mode="allgather",
                       precision=self.precision)
        v = ops.linear(x, p["wv"], bv, out_dtype=x.dtype, tp_mode="allgather",
                       precision=self.precision)
        q = q.reshape(b, s, self.n_heads, hd)
        k = k.reshape(b, s, self.n_kv_heads, hd)
        v = v.reshape(b, s, self.n_kv_heads, hd)
        if self.use_rope:
            q = apply_rope(q, positions, self.rope_theta)
            k = apply_rope(k, positions, self.rope_theta)
        return q, k, v

    def __call__(self, p, x, *, positions=None, residual=None):
        """Self-attention over x: (B, S, D) at `positions` (B, S), 0..S-1 by
        default; `residual` fuses into the output projection's write-back.
        (JAX's cross-attention `kv=` comes with the encoder-decoder model.)"""
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, device=x.device).expand(b, s)
        q, k, v = self._qkv(p, x, positions)
        groups = self.n_heads // self.n_kv_heads
        k, v = _repeat_kv(k, groups), _repeat_kv(v, groups)
        if k.shape[1] > self.chunked_threshold:
            o = chunked_attention(q, k, v, causal=self.causal)
        else:
            o = full_attention(q, k, v, causal=self.causal)
        o = o.reshape(b, s, self.n_heads * self.hd)
        return ops.linear(o, p["wo"], residual=residual, out_dtype=x.dtype,
                          tp_mode="reduce_scatter", precision=self.precision)

    # ---------------- paged KV cache ----------------

    @staticmethod
    def _write_kv_pages(cache, page_ids, offs, k_new, v_new):
        """Scatter K/V rows into the page pools at (page_ids, offs), IN
        PLACE (`index_put_`; JAX returns an updated copy).  Shared by decode
        (one row per slot), chunked prefill and the verify window.  Free
        slots' rows land on the dump page; nothing is ever zeroed.  An int8
        cache (it describes itself by its "k_scale" key) quantizes each row
        and head on write, with its scale beside it."""
        idx = (page_ids.long(), offs.long())
        if "k_scale" in cache:
            spec = QuantSpec("int8", "tile")
            qk, ks = quantize(k_new, spec, axis=-1)
            qv, vs = quantize(v_new, spec, axis=-1)
            cache["k_pages"].index_put_(idx, qk)
            cache["v_pages"].index_put_(idx, qv)
            cache["k_scale"].index_put_(idx, ks[..., 0])
            cache["v_scale"].index_put_(idx, vs[..., 0])
            return cache
        dt = cache["k_pages"].dtype
        cache["k_pages"].index_put_(idx, k_new.to(dt))
        cache["v_pages"].index_put_(idx, v_new.to(dt))
        return cache

    def init_paged_cache(self, num_pages: int, page_size: int, *,
                         dtype=torch.float32, device="cuda", kv_quant=None):
        """Flat page-pool cache: (num_pages, page_size, Hkv, hd) per operand.
        `kv_quant` (a quantized QuantSpec, e.g. QuantSpec("int8")) stores
        int8 payloads plus per-row f32 scale pages (num_pages, page_size,
        Hkv); the cache describes itself by its `k_scale` key."""
        shape = (num_pages, page_size, self.n_kv_heads, self.hd)
        if kv_quant is not None and kv_quant.quantized:
            if kv_quant.dtype != "int8":
                raise NotImplementedError(
                    f"{kv_quant.dtype} KV pages are not ported yet (ROADMAP queue 1 "
                    "item 8); int8 is")
            return {"k_pages": torch.zeros(shape, dtype=torch.int8, device=device),
                    "v_pages": torch.zeros(shape, dtype=torch.int8, device=device),
                    "k_scale": torch.ones(shape[:3], dtype=torch.float32, device=device),
                    "v_scale": torch.ones(shape[:3], dtype=torch.float32, device=device)}
        return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
                "v_pages": torch.zeros(shape, dtype=dtype, device=device)}

    @staticmethod
    def _scales(cache):
        return dict(k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"))

    def decode_paged(self, p, x, cache, index, page_table, lengths, *,
                     residual=None):
        """One decode step against a paged KV cache.  x: (B, 1, D); index:
        (B,) per-slot positions; page_table: (B, W) int32 page ids (free
        slots point at the dump page); lengths: (B,) int32 live counts
        (index+1 for active slots, 0 for free ones).  The cache is written
        in place and returned."""
        b = x.shape[0]
        ps = cache["k_pages"].shape[1]
        idx_b = torch.broadcast_to(torch.as_tensor(index, device=x.device), (b,)).long()
        q, k_new, v_new = self._qkv(p, x, idx_b[:, None])
        rows = torch.arange(b, device=x.device)
        page_ids = page_table[rows, idx_b // ps]
        self._write_kv_pages(cache, page_ids, idx_b % ps, k_new[:, 0], v_new[:, 0])
        if ops.current_policy().resolve(x) == "torch":
            o = paged_decode_ref(q[:, 0], cache["k_pages"], cache["v_pages"],
                                 page_table, lengths, **self._scales(cache))
        else:  # both CUDA backends: the A/B they differ in is the GEMM
            o = mx_flash_decode(q[:, 0].contiguous(), cache["k_pages"],
                                cache["v_pages"], page_table, lengths,
                                **self._scales(cache))
        o = o.reshape(b, 1, self.n_heads * self.hd)
        out = ops.linear(o, p["wo"], residual=residual, out_dtype=x.dtype,
                         tp_mode="reduce_scatter", precision=self.precision)
        return out, cache

    def _write_window(self, p, x, cache, index, page_table):
        """q of the S tokens at positions [index, index+S) per slot, after
        their K/V rows are written into the pages."""
        b, sq, _ = x.shape
        ps = cache["k_pages"].shape[1]
        idx_b = torch.broadcast_to(torch.as_tensor(index, device=x.device), (b,)).long()
        positions = idx_b[:, None] + torch.arange(sq, device=x.device)  # (B, S)
        q, k_new, v_new = self._qkv(p, x, positions)
        page_ids = torch.gather(page_table.long(), 1, positions // ps)
        self._write_kv_pages(cache, page_ids, positions % ps, k_new, v_new)
        return q, idx_b

    def prefill_paged(self, p, x, cache, index, page_table, *, residual=None):
        """Chunked prefill writing K/V directly into pages: x (B, S, D)
        fills rows for positions [index, index+S), then attends causally
        over the paged prefix through the plain `paged_prefill_ref` (JAX
        uses its gather oracle on every backend too)."""
        b, sq, _ = x.shape
        q, idx_b = self._write_window(p, x, cache, index, page_table)
        o = paged_prefill_ref(q, cache["k_pages"], cache["v_pages"], page_table, idx_b,
                              **self._scales(cache))
        o = o.reshape(b, sq, self.n_heads * self.hd)
        out = ops.linear(o, p["wo"], residual=residual, out_dtype=x.dtype,
                         tp_mode="reduce_scatter", precision=self.precision)
        return out, cache

    def verify_paged(self, p, x, cache, index, page_table, lengths, *,
                     residual=None):
        """Batched-verify step of speculative decoding: x (B, S, D) holds
        each slot's S = k+1 window tokens (the committed token plus k
        drafts).  Their K/V rows for positions [index, index+S) are written
        first (quantized on write for int8), then all S rows attend in one
        `mx_flash_verify` launch.  lengths: (B,) live counts INCLUDING the
        window (index + S for active slots, 0 for free ones, whose writes
        land on the dump page and whose rows are zero)."""
        b, sq, _ = x.shape
        q, _ = self._write_window(p, x, cache, index, page_table)
        if ops.current_policy().resolve(x) == "torch":
            o = paged_verify_ref(q, cache["k_pages"], cache["v_pages"], page_table,
                                 lengths, **self._scales(cache))
        else:  # both CUDA backends, as in decode_paged
            o = mx_flash_verify(q.contiguous(), cache["k_pages"], cache["v_pages"],
                                page_table, lengths, **self._scales(cache))
        o = o.reshape(b, sq, self.n_heads * self.hd)
        out = ops.linear(o, p["wo"], residual=residual, out_dtype=x.dtype,
                         tp_mode="reduce_scatter", precision=self.precision)
        return out, cache


@dataclasses.dataclass(frozen=True)
class MLP(Module):
    d_model: int
    d_ff: int
    activation: str = "silu"  # "silu" => gated (SwiGLU); "gelu"/"relu" => plain
    precision: Optional[str] = None

    @property
    def gated(self) -> bool:
        return self.activation == "silu"

    def build(self, mk: Builder):
        p = {"wi": mk.param("wi", (self.d_model, self.d_ff)),
             "wo": mk.param("wo", (self.d_ff, self.d_model))}
        if self.gated:
            p["wg"] = mk.param("wg", (self.d_model, self.d_ff))
        return p

    def __call__(self, p, x, *, residual=None):
        """silu(x@wg) * (x@wi) is ONE kernel on "cuda_mx" (two accumulators,
        gating at the write-back); the down-projection fuses the residual."""
        if self.gated:
            h = ops.linear(x, p["wi"], w_gate=p["wg"], activation="swiglu",
                           out_dtype=x.dtype, tp_mode="allgather",
                           precision=self.precision)
        else:
            act = self.activation if self.activation in ("gelu", "relu") else "relu"
            h = ops.linear(x, p["wi"], activation=act, out_dtype=x.dtype,
                           tp_mode="allgather", precision=self.precision)
        return ops.linear(h, p["wo"], residual=residual, out_dtype=x.dtype,
                          tp_mode="reduce_scatter", precision=self.precision)
