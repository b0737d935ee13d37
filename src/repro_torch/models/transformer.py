"""Decoder-only LM over homogeneous segments (port of
`repro/models/transformer.py`, the paged-serving subset for "dense" blocks).

Layers of a segment keep their parameters stacked on a leading layer axis
(the JAX layout, which `jax.lax.scan` consumes); the port walks the layers
in a Python loop over views of the stacks.  The paged KV cache is stacked
the same way, (n_layers, P, ps, Hkv, hd) per operand, and every step writes
it in place.

`DecoderLM.__call__` is the full forward (the draft model of speculative
decoding); `verify_step_paged` scores a speculative window of S tokens per
slot in one pass over the layers.

Not ported yet: the dense cache path (`make_cache`, `decode_step`,
`prefill_step`), the MoE / SSM / xLSTM / shared-block / encoder-decoder /
prefix-embedding variants.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from .layers import MLP, Attention, Embedding, rms_norm
from .modules import Builder, Module, layer_slice


@dataclasses.dataclass(frozen=True)
class TransformerBlock(Module):
    """Pre-norm attention + MLP block."""

    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 1e4
    activation: str = "silu"
    chunk_threshold: int = 2048
    precision: Optional[str] = None

    def _attn(self) -> Attention:
        return Attention(self.d_model, self.n_heads, self.n_kv_heads, self.head_dim,
                         qkv_bias=self.qkv_bias, rope_theta=self.rope_theta,
                         chunked_threshold=self.chunk_threshold,
                         precision=self.precision)

    def _ffn(self) -> MLP:
        return MLP(self.d_model, self.d_ff, activation=self.activation,
                   precision=self.precision)

    def build(self, mk: Builder):
        return {
            "ln1": mk.param("ln1", (self.d_model,), init="ones"),
            "attn": mk.child("attn", self._attn()),
            "ln2": mk.param("ln2", (self.d_model,), init="ones"),
            "ffn": mk.child("ffn", self._ffn()),
        }

    def init_paged_cache(self, num_pages, page_size, *, dtype=torch.float32,
                         device="cuda", kv_quant=None):
        return self._attn().init_paged_cache(num_pages, page_size, dtype=dtype,
                                             device=device, kv_quant=kv_quant)

    def _ffn_residual(self, p, x):
        return self._ffn()(p["ffn"], rms_norm(x, p["ln2"]), residual=x)

    def __call__(self, p, x):
        """The full-sequence block: (x, aux) with aux 0 for a dense MLP."""
        x = self._attn()(p["attn"], rms_norm(x, p["ln1"]), residual=x)
        return self._ffn_residual(p, x), torch.zeros((), device=x.device)

    def decode_paged(self, p, x, cache, index, page_table, lengths):
        # residual adds fuse into the output-projection write-backs
        x, cache = self._attn().decode_paged(p["attn"], rms_norm(x, p["ln1"]), cache,
                                             index, page_table, lengths, residual=x)
        return self._ffn_residual(p, x), cache

    def prefill_paged(self, p, x, cache, index, page_table):
        """Multi-token page-writing step (chunked prefill into pages)."""
        x, cache = self._attn().prefill_paged(p["attn"], rms_norm(x, p["ln1"]), cache,
                                              index, page_table, residual=x)
        return self._ffn_residual(p, x), cache

    def verify_paged(self, p, x, cache, index, page_table, lengths):
        """Speculative batched-verify step: S window tokens per slot."""
        x, cache = self._attn().verify_paged(p["attn"], rms_norm(x, p["ln1"]), cache,
                                             index, page_table, lengths, residual=x)
        return self._ffn_residual(p, x), cache


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str
    n: int


def make_block(kind: str, cfg) -> Module:
    """cfg is an ArchConfig (configs/base.py).  Only "dense" is ported."""
    if kind != "dense":
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP queue 1 items 12-14)")
    prec = getattr(cfg, "precision", None)
    return TransformerBlock(
        cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, head_dim=cfg.head_dim,
        qkv_bias=cfg.qkv_bias, rope_theta=cfg.rope_theta, activation=cfg.activation,
        chunk_threshold=cfg.attn_chunk_threshold, precision=prec)


@dataclasses.dataclass(frozen=True)
class DecoderLM(Module):
    """Decoder LM over segments of stacked dense blocks, tied or untied head."""

    cfg: Any  # ArchConfig

    def segments(self) -> Tuple[Segment, ...]:
        return tuple(Segment(k, n) for k, n in self.cfg.blocks)

    def build(self, mk: Builder):
        cfg = self.cfg
        p = {"embed": mk.child("embed", Embedding(cfg.vocab, cfg.d_model))}
        for i, seg in enumerate(self.segments()):
            p[f"seg{i}"] = mk.stacked(f"seg{i}", make_block(seg.kind, cfg), seg.n)
        p["ln_f"] = mk.param("ln_f", (cfg.d_model,), init="ones")
        if not cfg.tie_embeddings:
            p["lm_head"] = mk.param("lm_head", (cfg.d_model, cfg.vocab))
        return p

    def _embed_inputs(self, p, tokens):
        return Embedding(self.cfg.vocab, self.cfg.d_model)(p["embed"], tokens)

    def _head(self, p, x):
        """Final norm + LM head -> f32 logits.  The tied head is the plain
        `x @ table.T`; an untied head rides the MX dispatch."""
        from ..core import ops

        cfg = self.cfg
        x = rms_norm(x, p["ln_f"])
        if cfg.tie_embeddings:
            return Embedding(cfg.vocab, cfg.d_model).attend(p["embed"], x)
        return ops.linear(x, p["lm_head"], out_dtype=torch.float32,
                          tp_mode="allgather")

    def __call__(self, p, tokens):
        """tokens: (B, S) -> (logits (B, S, vocab) f32, aux loss).  Dense
        blocks carry no auxiliary loss, so aux is a zero scalar."""
        x = self._embed_inputs(p, tokens)
        aux = torch.zeros((), device=x.device)
        for i, seg in enumerate(self.segments()):
            block = make_block(seg.kind, self.cfg)
            for layer in range(seg.n):
                x, a = block(layer_slice(p[f"seg{i}"], layer), x)
                aux = aux + a
        return self._head(p, x), aux

    # ---- paged decode / chunked prefill ----

    def supports_paged(self) -> bool:
        """Attention-only segments with no shared block and no modality
        prefix -- and, in this port, dense blocks only."""
        cfg = self.cfg
        return (not cfg.shared_attn_every and not cfg.frontend_dim
                and all(kind == "dense" for kind, _ in cfg.blocks))

    def make_paged_cache(self, num_pages: int, page_size: int, *,
                         dtype=torch.float32, device="cuda", kv_quant=None):
        """Per segment, layer-stacked page pools (n, num_pages, page_size,
        Hkv, hd), with (n, num_pages, page_size, Hkv) scale pages for an
        int8 `kv_quant`.  The page table and lengths are per-step scheduler
        outputs shared by every layer, not part of the cache."""
        if not self.supports_paged():
            raise ValueError(f"{self.cfg.name}: paged decode needs dense "
                             "attention-only segments")
        cache = {}
        for i, seg in enumerate(self.segments()):
            one = make_block(seg.kind, self.cfg).init_paged_cache(
                num_pages, page_size, dtype=dtype, device=device, kv_quant=kv_quant)
            cache[f"seg{i}"] = {k: v.expand(seg.n, *v.shape).clone()
                                for k, v in one.items()}
        return cache

    def _run_layers(self, p, x, cache, step):
        for i, seg in enumerate(self.segments()):
            block = make_block(seg.kind, self.cfg)
            for layer in range(seg.n):
                x, _ = step(block, layer_slice(p[f"seg{i}"], layer), x,
                            layer_slice(cache[f"seg{i}"], layer))
        return x

    def decode_step_paged(self, p, token, cache, index, page_table, lengths):
        """One token for the whole stack against the paged KV cache.
        token: (B, 1); index: (B,) per-slot positions; page_table: (B, W)
        int32; lengths: (B,) int32.  Returns (logits (B, 1, V) f32, cache);
        the cache is updated in place."""
        x = self._embed_inputs(p, token)
        x = self._run_layers(p, x, cache, lambda blk, lp, h, lc: blk.decode_paged(
            lp, h, lc, index, page_table, lengths))
        return self._head(p, x), cache

    def prefill_step_paged(self, p, tokens, cache, index, page_table):
        """S prompt tokens through the whole stack in ONE step, written
        directly into the pages.  tokens: (B, S); index: (B,) chunk start
        positions; page_table: (B, W).  Returns (logits, cache)."""
        if not self.supports_paged():
            raise ValueError(f"{self.cfg.name}: paged prefill needs dense "
                             "attention-only segments")
        x = self._embed_inputs(p, tokens)
        x = self._run_layers(p, x, cache, lambda blk, lp, h, lc: blk.prefill_paged(
            lp, h, lc, index, page_table))
        return self._head(p, x), cache

    def verify_step_paged(self, p, tokens, cache, index, page_table, lengths):
        """Score S = k+1 window tokens per slot through the whole stack in
        one pass -- the speculative verify.  tokens: (B, S) (each slot's
        committed token, then its k drafts); index: (B,) window start
        positions; lengths: (B,) live counts including the window.  Returns
        (logits (B, S, V) f32, cache): logits[:, r] scores position
        index + r, so row 0 is the plain decode step's output and rows
        1..k are the extra tokens this pass buys."""
        if not self.supports_paged():
            raise ValueError(f"{self.cfg.name}: speculative verify needs dense "
                             "attention-only segments")
        x = self._embed_inputs(p, tokens)
        x = self._run_layers(p, x, cache, lambda blk, lp, h, lc: blk.verify_paged(
            lp, h, lc, index, page_table, lengths))
        return self._head(p, x), cache


def build_model(cfg) -> DecoderLM:
    """ArchConfig -> model module (decoder-only LMs)."""
    if cfg.model_kind == "encdec":
        raise NotImplementedError(
            "encoder-decoder models are not ported yet (ROADMAP queue 1 item 14)")
    return DecoderLM(cfg)
