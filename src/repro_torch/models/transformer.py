"""Decoder-only LM over homogeneous segments (port of
`repro/models/transformer.py`, the decoder subset: "dense", "moe" and
"mamba2" blocks, with zamba2's weight-tied shared block).

Layers of a segment keep their parameters stacked on a leading layer axis
(the JAX layout, which `jax.lax.scan` consumes); the port walks the layers
in a Python loop over views of the stacks.  Caches are stacked the same
way -- the paged KV cache (n_layers, P, ps, Hkv, hd) per operand, the
dense cache (n_layers, B, max_len, Hkv, hd), the Mamba2 state (n_layers, B,
...) -- and every step writes them in place.

`DecoderLM.__call__` is the full forward (the cacheless prefill and the
draft model of speculative decoding), returning the MoE blocks' summed
auxiliary loss beside the logits.  With `shared_attn_every` (zamba2) the
shared transformer block runs after every group of that many layers of a
segment, with the same weights each time, and has a dense KV cache of its
own per application (`shared{i}`).  `decode_step` / `prefill_step` run the
dense cache; `decode_step_paged` / `prefill_step_paged` /
`verify_step_paged` the paged one (attention-only models).

Not ported yet: the xLSTM, encoder-decoder and prefix-embedding variants.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from .layers import MLP, Attention, Embedding, rms_norm
from .modules import Builder, Module, layer_slice
from .moe import MoE
from .ssm import Mamba2Block


@dataclasses.dataclass(frozen=True)
class TransformerBlock(Module):
    """Pre-norm attention + MLP or MoE block."""

    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 1e4
    use_moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    activation: str = "silu"
    chunk_threshold: int = 2048
    precision: Optional[str] = None
    moe_groups: int = 1
    moe_capacity_factor: float = 1.25

    def _attn(self) -> Attention:
        return Attention(self.d_model, self.n_heads, self.n_kv_heads, self.head_dim,
                         qkv_bias=self.qkv_bias, rope_theta=self.rope_theta,
                         chunked_threshold=self.chunk_threshold,
                         precision=self.precision)

    def _ffn(self):
        if self.use_moe:
            return MoE(self.d_model, self.d_ff, self.n_experts, self.top_k,
                       activation=self.activation, n_groups=self.moe_groups,
                       capacity_factor=self.moe_capacity_factor,
                       precision=self.precision)
        return MLP(self.d_model, self.d_ff, activation=self.activation,
                   precision=self.precision)

    def build(self, mk: Builder):
        return {
            "ln1": mk.param("ln1", (self.d_model,), init="ones"),
            "attn": mk.child("attn", self._attn()),
            "ln2": mk.param("ln2", (self.d_model,), init="ones"),
            "ffn": mk.child("ffn", self._ffn()),
        }

    def init_cache(self, batch, max_len, *, dtype=torch.bfloat16, device="cuda"):
        return self._attn().init_cache(batch, max_len, dtype=dtype, device=device)

    def init_paged_cache(self, num_pages, page_size, *, dtype=torch.float32,
                         device="cuda", kv_quant=None):
        return self._attn().init_paged_cache(num_pages, page_size, dtype=dtype,
                                             device=device, kv_quant=kv_quant)

    def _ffn_residual(self, p, x):
        """(x + ffn(rms_norm(x)), the MoE's auxiliary loss or None).  A dense
        MLP fuses the residual add into its down-projection write-back; the
        MoE adds it after the combine, as JAX does."""
        h = rms_norm(x, p["ln2"])
        if self.use_moe:
            y, aux = self._ffn()(p["ffn"], h)
            return x + y, aux
        return self._ffn()(p["ffn"], h, residual=x), None

    def __call__(self, p, x):
        """The full-sequence block: (x, aux), aux 0 for a dense MLP."""
        x = self._attn()(p["attn"], rms_norm(x, p["ln1"]), residual=x)
        x, aux = self._ffn_residual(p, x)
        return x, torch.zeros((), device=x.device) if aux is None else aux

    def decode(self, p, x, cache, index):
        """One token against the dense cache (index scalar or (B,))."""
        x, cache = self._attn().decode(p["attn"], rms_norm(x, p["ln1"]), cache, index,
                                       residual=x)
        return self._ffn_residual(p, x)[0], cache

    def prefill(self, p, x, cache, index):
        """Multi-token dense-cache-writing step (chunked prefill)."""
        x, cache = self._attn().prefill(p["attn"], rms_norm(x, p["ln1"]), cache, index,
                                        residual=x)
        return self._ffn_residual(p, x)[0], cache

    def decode_paged(self, p, x, cache, index, page_table, lengths):
        # residual adds fuse into the output-projection write-backs
        x, cache = self._attn().decode_paged(p["attn"], rms_norm(x, p["ln1"]), cache,
                                             index, page_table, lengths, residual=x)
        return self._ffn_residual(p, x)[0], cache

    def prefill_paged(self, p, x, cache, index, page_table):
        """Multi-token page-writing step (chunked prefill into pages)."""
        x, cache = self._attn().prefill_paged(p["attn"], rms_norm(x, p["ln1"]), cache,
                                              index, page_table, residual=x)
        return self._ffn_residual(p, x)[0], cache

    def verify_paged(self, p, x, cache, index, page_table, lengths):
        """Speculative batched-verify step: S window tokens per slot."""
        x, cache = self._attn().verify_paged(p["attn"], rms_norm(x, p["ln1"]), cache,
                                             index, page_table, lengths, residual=x)
        return self._ffn_residual(p, x)[0], cache


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str
    n: int


def make_block(kind: str, cfg) -> Module:
    """cfg is an ArchConfig (configs/base.py).  "dense", "moe" and "mamba2"
    are ported."""
    if kind == "mamba2":
        return Mamba2Block(cfg.d_model, d_state=cfg.ssm_state, chunk=cfg.ssm_chunk)
    if kind not in ("dense", "moe"):
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP queue 1 items 3-5)")
    prec = getattr(cfg, "precision", None)
    return TransformerBlock(
        cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, head_dim=cfg.head_dim,
        qkv_bias=cfg.qkv_bias, rope_theta=cfg.rope_theta, use_moe=(kind == "moe"),
        n_experts=cfg.n_experts, top_k=cfg.top_k, activation=cfg.activation,
        chunk_threshold=cfg.attn_chunk_threshold, precision=prec,
        moe_groups=cfg.moe_groups, moe_capacity_factor=cfg.moe_capacity_factor)


@dataclasses.dataclass(frozen=True)
class DecoderLM(Module):
    """Decoder LM over segments of stacked dense, MoE or Mamba2 blocks, with
    an optional Zamba-style weight-tied shared block; tied or untied
    head."""

    cfg: Any  # ArchConfig

    def segments(self) -> Tuple[Segment, ...]:
        return tuple(Segment(k, n) for k, n in self.cfg.blocks)

    def _shared_block(self) -> TransformerBlock:
        """The shared attention + MLP block (JAX builds it with
        `d_ff or 4 * d_model` and the config's head_dim and rope_theta)."""
        cfg = self.cfg
        return TransformerBlock(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.d_ff or 4 * cfg.d_model, head_dim=cfg.head_dim,
                                rope_theta=cfg.rope_theta)

    def build(self, mk: Builder):
        cfg = self.cfg
        p = {"embed": mk.child("embed", Embedding(cfg.vocab, cfg.d_model))}
        for i, seg in enumerate(self.segments()):
            p[f"seg{i}"] = mk.stacked(f"seg{i}", make_block(seg.kind, cfg), seg.n)
        if cfg.shared_attn_every:
            p["shared"] = mk.child("shared", self._shared_block())
        p["ln_f"] = mk.param("ln_f", (cfg.d_model,), init="ones")
        if not cfg.tie_embeddings:
            p["lm_head"] = mk.param("lm_head", (cfg.d_model, cfg.vocab))
        return p

    def _walk(self, seg: Segment):
        """The segment's schedule: ("layer", l) for each layer and, with a
        shared block, ("shared", g) after each group g of
        `shared_attn_every` layers (JAX scans the groups of a reshaped
        stack, so n must be a multiple)."""
        every = self.cfg.shared_attn_every
        if not every:
            for layer in range(seg.n):
                yield "layer", layer
            return
        if seg.n % every:
            raise ValueError(f"{self.cfg.name}: {seg.n} layers are not groups of "
                             f"shared_attn_every={every}")
        for g in range(seg.n // every):
            for layer in range(g * every, (g + 1) * every):
                yield "layer", layer
            yield "shared", g

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
        """tokens: (B, S) -> (logits (B, S, vocab) f32, aux loss): the sum of
        the MoE blocks' load-balancing losses (0 for dense, Mamba2 and
        shared blocks' MLPs)."""
        x = self._embed_inputs(p, tokens)
        aux = torch.zeros((), device=x.device)
        for i, seg in enumerate(self.segments()):
            block = make_block(seg.kind, self.cfg)
            for what, j in self._walk(seg):
                if what == "shared":
                    x, a = self._shared_block()(p["shared"], x)  # tied weights
                elif seg.kind == "mamba2":
                    x, a = block(layer_slice(p[f"seg{i}"], j), x), 0.0
                else:
                    x, a = block(layer_slice(p[f"seg{i}"], j), x)
                aux = aux + a
        return self._head(p, x), aux

    # ---- dense cache: decode / chunked prefill ----

    def make_cache(self, batch: int, max_len: int, *, dtype=torch.bfloat16,
                   device="cuda"):
        """{"seg{i}": the segment's layer-stacked cache -- a (n, batch,
        max_len, Hkv, hd) K/V rectangle of `dtype` for attention blocks,
        the f32 conv window and SSM state for Mamba2 blocks --,
        "shared{i}": the shared block's K/V per application (after each
        group of a Mamba2 segment)}, all zeroed."""
        cfg = self.cfg
        cache = {}
        for i, seg in enumerate(self.segments()):
            block = make_block(seg.kind, cfg)
            if seg.kind == "mamba2":
                one = block.init_state(batch, device=device)
            else:
                one = block.init_cache(batch, max_len, dtype=dtype, device=device)
            cache[f"seg{i}"] = {k: v.expand(seg.n, *v.shape).clone() for k, v in one.items()}
            if cfg.shared_attn_every and seg.kind == "mamba2":
                napp = seg.n // cfg.shared_attn_every
                one = self._shared_block().init_cache(batch, max_len, dtype=dtype,
                                                      device=device)
                cache[f"shared{i}"] = {k: v.expand(napp, *v.shape).clone()
                                       for k, v in one.items()}
        return cache

    def supports_chunked_prefill(self) -> bool:
        """`prefill_step` covers attention-only segments (state-block,
        shared-block and prefix models step their prompts token by token,
        as in JAX)."""
        return self.supports_paged()

    def decode_step(self, p, token, cache, index):
        """One token for the whole stack against the dense cache.  token:
        (B, 1); index: a scalar position or (B,) per-slot positions.
        Returns (logits (B, 1, V) f32, cache), the cache updated in place."""
        x = self._embed_inputs(p, token)
        for i, seg in enumerate(self.segments()):
            block = make_block(seg.kind, self.cfg)
            for what, j in self._walk(seg):
                if what == "shared":
                    x, _ = self._shared_block().decode(
                        p["shared"], x, layer_slice(cache[f"shared{i}"], j), index)
                elif seg.kind == "mamba2":
                    x, _ = block.decode(layer_slice(p[f"seg{i}"], j), x,
                                        layer_slice(cache[f"seg{i}"], j))
                else:
                    x, _ = block.decode(layer_slice(p[f"seg{i}"], j), x,
                                        layer_slice(cache[f"seg{i}"], j), index)
        return self._head(p, x), cache

    def prefill_step(self, p, tokens, cache, index):
        """S prompt tokens through the whole stack in one step, writing dense
        cache rows [index, index+S) in place.  tokens: (B, S); index: the
        chunk's start position.  Returns (logits, cache)."""
        if not self.supports_chunked_prefill():
            raise ValueError(f"{self.cfg.name}: chunked prefill needs "
                             "attention-only segments")
        x = self._embed_inputs(p, tokens)
        x = self._run_layers(p, x, cache, lambda blk, lp, h, lc: blk.prefill(
            lp, h, lc, index))
        return self._head(p, x), cache

    # ---- paged decode / chunked prefill ----

    def supports_paged(self) -> bool:
        """Attention-only (dense or MoE) segments with no shared block and
        no modality prefix."""
        cfg = self.cfg
        return (not cfg.shared_attn_every and not cfg.frontend_dim
                and all(kind in ("dense", "moe") for kind, _ in cfg.blocks))

    def make_paged_cache(self, num_pages: int, page_size: int, *,
                         dtype=torch.float32, device="cuda", kv_quant=None):
        """Per segment, layer-stacked page pools (n, num_pages, page_size,
        Hkv, hd), with (n, num_pages, page_size, Hkv) scale pages for an
        int8 or fp8 `kv_quant`.  The page table and lengths are per-step scheduler
        outputs shared by every layer, not part of the cache."""
        if not self.supports_paged():
            raise ValueError(f"{self.cfg.name}: paged decode needs "
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
            raise ValueError(f"{self.cfg.name}: paged prefill needs "
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
            raise ValueError(f"{self.cfg.name}: speculative verify needs "
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
