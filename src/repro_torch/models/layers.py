"""Transformer building blocks (port of `repro/models/layers.py`): norms,
RoPE, linear, embedding, GQA attention (full, chunked, cross-attention
over given K/V, and over a dense or paged KV cache), MLP.

All weight-times-activation contractions route through `core.ops.linear`
(the MX dispatch); paged decode attention through `mx_flash_decode`, the
speculative window through `mx_flash_verify`, and the full and chunked
attention of the full forward through `mx_flash_attention` on the CUDA
backends (JAX's models compute that attention in jnp; the TPU kernel
computes the same function per head).  The tied LM head, the paged
prefill attention and the dense-cache decode and prefill attention stay
plain PyTorch, as they stay outside any Pallas kernel in JAX.  An int8 or
fp8 (e4m3) KV cache quantizes each K/V row on write (per row and head) and
the attention dequantizes on read.  Every projection takes the block's
`precision` declaration, or the ambient `use_precision()` context.

The dense cache (`init_cache`, `decode`, `prefill`) is the
(batch, max_len, Hkv, hd) rectangle of JAX's, written in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..core import ops
from ..core.precision import QuantSpec
from ..kernels.mx_flash_attention import mx_flash_attention
from ..kernels.mx_flash_decode import mx_flash_decode, mx_flash_verify
from ..kernels.quant import quantize
from ..kernels.ref import paged_decode_ref, paged_prefill_ref, paged_verify_ref
from .modules import Builder, Module

# a quantized page pool's payload dtype -> its QuantSpec dtype name
_PAGE_SPECS = {torch.int8: "int8", torch.float8_e4m3fn: "fp8_e4m3"}


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
    axes: Tuple[Optional[str], Optional[str]] = ("embed", "mlp")  # logical axes of w

    def build(self, mk: Builder):
        p = {"w": mk.param("w", (self.d_in, self.d_out), self.axes)}
        if self.bias:
            p["b"] = mk.param("b", (self.d_out,), (self.axes[1],), init="zeros")
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
        return {"table": mk.param("table", (self.vocab, self.d), ("vocab", "embed"), scale=0.02)}

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


def _promoted(p: torch.Tensor, v: torch.Tensor):
    """p and v in their promoted dtype: jnp.einsum promotes mixed operands
    (f32 probabilities against a bf16 cache give f32), torch.einsum does
    not."""
    dt = torch.promote_types(p.dtype, v.dtype)
    return p.to(dt), v.to(dt)


def full_attention(q, k, v, *, causal: bool, q_offset=0) -> torch.Tensor:
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
    return torch.einsum("bhqk,bkhd->bqhd", *_promoted(p, v))


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
            "wq": mk.param("wq", (self.d_model, self.n_heads * hd), ("embed", "heads")),
            "wk": mk.param("wk", (self.d_model, self.n_kv_heads * hd), ("embed", "heads")),
            "wv": mk.param("wv", (self.d_model, self.n_kv_heads * hd), ("embed", "heads")),
            "wo": mk.param("wo", (self.n_heads * hd, self.d_model), ("heads", "embed")),
        }
        if self.qkv_bias:
            p["bq"] = mk.param("bq", (self.n_heads * hd,), ("heads",), init="zeros")
            p["bk"] = mk.param("bk", (self.n_kv_heads * hd,), ("heads",), init="zeros")
            p["bv"] = mk.param("bv", (self.n_kv_heads * hd,), ("heads",), init="zeros")
        return p

    def _proj(self, p, x, name, heads, positions):
        """One of the q / k / v projections, (B, S, heads, hd), rotated by
        RoPE at `positions` for q and k."""
        b, s, _ = x.shape
        bias = p["b" + name] if self.qkv_bias else None
        t = ops.linear(x, p["w" + name], bias, out_dtype=x.dtype, tp_mode="allgather",
                       precision=self.precision).reshape(b, s, heads, self.hd)
        if self.use_rope and name != "v":
            t = apply_rope(t, positions, self.rope_theta)
        return t

    def _qkv(self, p, x, positions):
        return (self._proj(p, x, "q", self.n_heads, positions),
                self._proj(p, x, "k", self.n_kv_heads, positions),
                self._proj(p, x, "v", self.n_kv_heads, positions))

    def __call__(self, p, x, *, positions=None, kv=None, residual=None):
        """Self-attention over x: (B, S, D) at `positions` (B, S), 0..S-1 by
        default; `residual` fuses into the output projection's write-back.
        With kv=(k, v), each (B, Sk, Hkv or H, hd), x attends over those
        instead, with no causal mask (cross-attention; JAX still computes
        x's own k and v there and drops them, the port projects q alone).
        On the CUDA backends both of JAX's branches (full attention, and
        the chunked online softmax past `chunked_threshold` keys) are one
        `mx_flash_attention` launch over every head, reading each kv head
        in place (Sk may differ from S, down to S = 1 at decode); the
        "torch" backend runs JAX's two plain forms."""
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, device=x.device).expand(b, s)
        if kv is None:
            q, k, v = self._qkv(p, x, positions)
            causal = self.causal
        else:
            q, (k, v) = self._proj(p, x, "q", self.n_heads, positions), kv
            causal = False
        if ops.current_policy().resolve(x) == "torch":
            groups = self.n_heads // self.n_kv_heads
            if k.shape[2] != self.n_heads:
                k, v = _repeat_kv(k, groups), _repeat_kv(v, groups)
            if k.shape[1] > self.chunked_threshold:
                o = chunked_attention(q, k, v, causal=causal)
            else:
                o = full_attention(q, k, v, causal=causal)
        else:
            o = mx_flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                   causal=causal)
        o = o.reshape(b, s, self.n_heads * self.hd)
        return ops.linear(o, p["wo"], residual=residual, out_dtype=x.dtype,
                          tp_mode="reduce_scatter", precision=self.precision)

    # ---------------- dense KV cache ----------------

    def init_cache(self, batch: int, max_len: int, *, dtype=torch.bfloat16,
                   device="cuda"):
        """The dense (batch, max_len, Hkv, hd) K and V rectangle, zeroed
        (bf16 by default, as in JAX)."""
        shape = (batch, max_len, self.n_kv_heads, self.hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def cache_axes(self):
        ax = ("batch", "cache_seq", "kv_heads", "head_dim")
        return {"k": ax, "v": ax}

    def decode(self, p, x, cache, index, *, residual=None):
        """One decode step against the dense cache.  x: (B, 1, D); index: a
        scalar position shared by the batch, or (B,) per-slot positions
        (continuous batching).  The new K/V row is written IN PLACE (JAX:
        `dynamic_update_slice` or a scatter into a copy); the attention is
        plain PyTorch on every backend, as it is jnp in JAX.  Returns
        (out, cache).  A scalar index given as a Python int stays on the
        host for the row write, so no tensor is read back (a "meta" step
        can run: `launch/dryrun.py`)."""
        b = x.shape[0]
        row = index if isinstance(index, int) else None
        index = torch.as_tensor(index, device=x.device)
        idx_b = torch.broadcast_to(index, (b,)).long()
        q, k_new, v_new = self._qkv(p, x, idx_b[:, None])
        dt = cache["k"].dtype
        if index.dim() == 0:
            row = int(index) if row is None else row
            cache["k"][:, row] = k_new[:, 0].to(dt)
            cache["v"][:, row] = v_new[:, 0].to(dt)
        else:  # per-slot scatter
            rows = torch.arange(b, device=x.device)
            cache["k"][rows, idx_b] = k_new[:, 0].to(dt)
            cache["v"][rows, idx_b] = v_new[:, 0].to(dt)
        # every cache row at or before each slot's own position, in JAX's
        # dtypes: f32 scores, probabilities in q's dtype, the PV promoted
        groups = self.n_heads // self.n_kv_heads
        k = _repeat_kv(cache["k"], groups)
        v = _repeat_kv(cache["v"], groups)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(self.hd)
        kpos = torch.arange(k.shape[1], device=x.device)[None, None, None, :]
        s = s.masked_fill(~(kpos <= idx_b[:, None, None, None]), float("-inf"))
        pr = torch.softmax(s, dim=-1).to(q.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", *_promoted(pr, v))
        o = o.reshape(b, 1, self.n_heads * self.hd)
        out = ops.linear(o, p["wo"], residual=residual, out_dtype=x.dtype,
                         tp_mode="reduce_scatter", precision=self.precision)
        return out, cache

    def prefill(self, p, x, cache, index, *, residual=None):
        """Chunked prefill into the dense cache: x (B, S, D) writes rows
        [index, index+S) in place (index a scalar shared by the batch) and
        attends causally over the cache at q_offset = index, plain on every
        backend (JAX: `full_attention(q_offset=index)`).  The causal mask
        never reads past the written prefix, so attending over the whole
        cache is exact."""
        b, sq, _ = x.shape
        index = int(index)
        positions = (index + torch.arange(sq, device=x.device)).expand(b, sq)
        q, k_new, v_new = self._qkv(p, x, positions)
        dt = cache["k"].dtype
        cache["k"][:, index:index + sq] = k_new.to(dt)
        cache["v"][:, index:index + sq] = v_new.to(dt)
        groups = self.n_heads // self.n_kv_heads
        o = full_attention(q, _repeat_kv(cache["k"], groups),
                           _repeat_kv(cache["v"], groups), causal=True, q_offset=index)
        o = o.reshape(b, sq, self.n_heads * self.hd)
        out = ops.linear(o, p["wo"], residual=residual, out_dtype=x.dtype,
                         tp_mode="reduce_scatter", precision=self.precision)
        return out, cache

    # ---------------- paged KV cache ----------------

    @staticmethod
    def _write_kv_pages(cache, page_ids, offs, k_new, v_new):
        """Scatter K/V rows into the page pools at (page_ids, offs), IN
        PLACE (`index_put_`; JAX returns an updated copy).  Shared by decode
        (one row per slot), chunked prefill and the verify window.  Free
        slots' rows land on the dump page; nothing is ever zeroed.  A
        quantized cache (it describes itself by its "k_scale" key; int8 or
        fp8 by its payload dtype) quantizes each row and head on write, with
        its scale beside it."""
        idx = (page_ids.long(), offs.long())
        if "k_scale" in cache:
            spec = QuantSpec(_PAGE_SPECS[cache["k_pages"].dtype], "tile")
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
        `kv_quant` (a quantized QuantSpec: QuantSpec("int8") or
        QuantSpec("fp8_e4m3")) stores payloads of its dtype plus per-row f32
        scale pages (num_pages, page_size, Hkv); the cache describes itself
        by its `k_scale` key."""
        shape = (num_pages, page_size, self.n_kv_heads, self.hd)
        if kv_quant is not None and kv_quant.quantized:
            dt = kv_quant.torch_dtype
            return {"k_pages": torch.zeros(shape, dtype=dt, device=device),
                    "v_pages": torch.zeros(shape, dtype=dt, device=device),
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
        first (quantized on write for int8 / fp8), then all S rows attend in one
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
        p = {"wi": mk.param("wi", (self.d_model, self.d_ff), ("embed", "mlp")),
             "wo": mk.param("wo", (self.d_ff, self.d_model), ("mlp", "embed"))}
        if self.gated:
            p["wg"] = mk.param("wg", (self.d_model, self.d_ff), ("embed", "mlp"))
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
