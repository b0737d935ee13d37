"""Transformer building blocks (port of `repro/models/layers.py`, the
paged-serving subset): norms, RoPE, linear, embedding, GQA attention over a
paged KV cache, MLP.

All weight-times-activation contractions route through `core.ops.linear`
(the MX dispatch); paged decode attention through `mx_flash_decode`.  The
tied LM head and the paged prefill attention stay plain PyTorch, as they
stay outside any Pallas kernel in JAX.

Not ported yet: `full_attention` / `chunked_attention` and the dense
(non-paged) cache path (`Attention.__call__`, `decode`, `prefill`), the
speculative `verify_paged`, and int8 KV pages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import ops
from ..kernels.mx_flash_decode import mx_flash_decode
from ..kernels.ref import paged_decode_ref, paged_prefill_ref
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


@dataclasses.dataclass(frozen=True)
class Attention(Module):
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 1e4
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

    # ---------------- paged KV cache ----------------

    @staticmethod
    def _write_kv_pages(cache, page_ids, offs, k_new, v_new):
        """Scatter K/V rows into the page pools at (page_ids, offs), IN
        PLACE (`index_put_`; JAX returns an updated copy).  Shared by decode
        (one row per slot) and chunked prefill (a chunk per slot).  Free
        slots' rows land on the dump page; nothing is ever zeroed."""
        dt = cache["k_pages"].dtype
        idx = (page_ids.long(), offs.long())
        cache["k_pages"].index_put_(idx, k_new.to(dt))
        cache["v_pages"].index_put_(idx, v_new.to(dt))
        return cache

    def init_paged_cache(self, num_pages: int, page_size: int, *,
                         dtype=torch.float32, device="cuda", kv_quant=None):
        """Flat page-pool cache: (num_pages, page_size, Hkv, hd) per operand."""
        if kv_quant is not None:
            raise NotImplementedError(
                "int8 KV pages are not ported yet (ROADMAP queue 1 item 8)")
        shape = (num_pages, page_size, self.n_kv_heads, self.hd)
        return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
                "v_pages": torch.zeros(shape, dtype=dtype, device=device)}

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
                                 page_table, lengths)
        else:  # both CUDA backends: the A/B they differ in is the GEMM
            o = mx_flash_decode(q[:, 0].contiguous(), cache["k_pages"],
                                cache["v_pages"], page_table, lengths)
        o = o.reshape(b, 1, self.n_heads * self.hd)
        out = ops.linear(o, p["wo"], residual=residual, out_dtype=x.dtype,
                         tp_mode="reduce_scatter", precision=self.precision)
        return out, cache

    def prefill_paged(self, p, x, cache, index, page_table, *, residual=None):
        """Chunked prefill writing K/V directly into pages: x (B, S, D)
        fills rows for positions [index, index+S), then attends causally
        over the paged prefix through the plain `paged_prefill_ref` (JAX
        uses its gather oracle on every backend too)."""
        b, sq, _ = x.shape
        ps = cache["k_pages"].shape[1]
        idx_b = torch.broadcast_to(torch.as_tensor(index, device=x.device), (b,)).long()
        positions = idx_b[:, None] + torch.arange(sq, device=x.device)  # (B, S)
        q, k_new, v_new = self._qkv(p, x, positions)
        page_ids = torch.gather(page_table.long(), 1, positions // ps)
        self._write_kv_pages(cache, page_ids, positions % ps, k_new, v_new)
        o = paged_prefill_ref(q, cache["k_pages"], cache["v_pages"], page_table, idx_b)
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
