"""Model stacks (port of `repro/models/transformer.py`): the decoder LM
over homogeneous segments of "dense", "moe", "mamba2", "mlstm" and
"slstm" blocks (with zamba2's weight-tied shared block and internvl2's
modality prefix), and the encoder-decoder (seamless).

Layers of a segment keep their parameters stacked on a leading layer axis
(the JAX layout, which `jax.lax.scan` consumes); the port walks the layers
in a Python loop over views of the stacks.  Caches are stacked the same
way -- the paged KV cache (n_layers, P, ps, Hkv, hd) per operand, the
dense cache (n_layers, B, max_len, Hkv, hd), a state block's recurrent
state (n_layers, B, ...) -- and every step writes them in place.

`DecoderLM.__call__` is the full forward (the cacheless prefill and the
draft model of speculative decoding), returning the MoE blocks' summed
auxiliary loss beside the logits; `prefix_embeds` (B, P, frontend_dim)
enter through `frontend_proj` ahead of the token embeddings.  With
`shared_attn_every` (zamba2) the shared transformer block runs after every
group of that many layers of a segment, with the same weights each time,
and has a dense KV cache of its own per application (`shared{i}`).
`decode_step` / `prefill_step` run the dense cache; `decode_step_paged` /
`prefill_step_paged` / `verify_step_paged` the paged one (attention-only
models).  `EncDecLM` encodes precomputed frame embeddings once and decodes
against them, its cross-attention K/V recomputed from the encoder output
at every layer of every step, as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ..core import ops
from .layers import MLP, Attention, Embedding, Linear, rms_norm
from .modules import Builder, Module, layer_slice
from .moe import MoE
from .ssm import Mamba2Block
from .xlstm import MLSTMBlock, SLSTMBlock

# the recurrent-state block kinds: block(p, x) -> x, block.decode(p, x,
# state), block.init_state(batch); every other kind is an attention block
STATE_KINDS = ("mamba2", "mlstm", "slstm")


def _stacked(one, n: int):
    """A layer's cache or state, stacked n times on a leading layer axis
    (its own storage, written in place)."""
    return {k: v.expand(n, *v.shape).clone() for k, v in one.items()}


@dataclasses.dataclass(frozen=True)
class TransformerBlock(Module):
    """Pre-norm attention + MLP or MoE block (an encoder block with
    causal=False; with cross_attention, seamless's decoder block: self-
    attention, then cross-attention over the encoder's K/V under its own
    norm `ln_x`, then the MLP)."""

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
    causal: bool = True
    cross_attention: bool = False

    def _attn(self) -> Attention:
        return Attention(self.d_model, self.n_heads, self.n_kv_heads, self.head_dim,
                         qkv_bias=self.qkv_bias, rope_theta=self.rope_theta,
                         causal=self.causal, chunked_threshold=self.chunk_threshold,
                         precision=self.precision)

    def _xattn(self) -> Attention:
        """The cross-attention (JAX builds it without the block's precision,
        bias, rope theta or chunk threshold)."""
        return Attention(self.d_model, self.n_heads, self.n_kv_heads, self.head_dim,
                         causal=False, use_rope=False)

    def _ffn(self):
        if self.use_moe:
            return MoE(self.d_model, self.d_ff, self.n_experts, self.top_k,
                       activation=self.activation, n_groups=self.moe_groups,
                       capacity_factor=self.moe_capacity_factor,
                       precision=self.precision)
        return MLP(self.d_model, self.d_ff, activation=self.activation,
                   precision=self.precision)

    def build(self, mk: Builder):
        p = {
            "ln1": mk.param("ln1", (self.d_model,), init="ones"),
            "attn": mk.child("attn", self._attn()),
            "ln2": mk.param("ln2", (self.d_model,), init="ones"),
            "ffn": mk.child("ffn", self._ffn()),
        }
        if self.cross_attention:
            p["ln_x"] = mk.param("ln_x", (self.d_model,), init="ones")
            p["xattn"] = mk.child("xattn", self._xattn())
        return p

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

    def _cross(self, p, x, enc_kv):
        """x + cross-attention of rms_norm(x, ln_x) over enc_kv = (k, v)."""
        if not self.cross_attention:
            return x
        if enc_kv is None:
            raise ValueError("a cross-attention block needs the encoder's K/V (enc_kv=)")
        return self._xattn()(p["xattn"], rms_norm(x, p["ln_x"]), kv=enc_kv, residual=x)

    def __call__(self, p, x, *, enc_kv=None):
        """The full-sequence block: (x, aux), aux 0 for a dense MLP."""
        x = self._attn()(p["attn"], rms_norm(x, p["ln1"]), residual=x)
        x, aux = self._ffn_residual(p, self._cross(p, x, enc_kv))
        return x, torch.zeros((), device=x.device) if aux is None else aux

    def decode(self, p, x, cache, index, *, enc_kv=None):
        """One token against the dense cache (index scalar or (B,))."""
        x, cache = self._attn().decode(p["attn"], rms_norm(x, p["ln1"]), cache, index,
                                       residual=x)
        return self._ffn_residual(p, self._cross(p, x, enc_kv))[0], cache

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
    """cfg is an ArchConfig (configs/base.py)."""
    prec = getattr(cfg, "precision", None)
    if kind in ("dense", "moe"):
        return TransformerBlock(
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, head_dim=cfg.head_dim,
            qkv_bias=cfg.qkv_bias, rope_theta=cfg.rope_theta, use_moe=(kind == "moe"),
            n_experts=cfg.n_experts, top_k=cfg.top_k, activation=cfg.activation,
            chunk_threshold=cfg.attn_chunk_threshold, precision=prec,
            moe_groups=cfg.moe_groups, moe_capacity_factor=cfg.moe_capacity_factor)
    if kind == "encdec":
        return TransformerBlock(
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, activation=cfg.activation, cross_attention=True,
            chunk_threshold=cfg.attn_chunk_threshold, precision=prec)
    if kind == "mamba2":
        return Mamba2Block(cfg.d_model, d_state=cfg.ssm_state, chunk=cfg.ssm_chunk)
    if kind == "mlstm":
        return MLSTMBlock(cfg.d_model, cfg.n_heads)
    if kind == "slstm":
        return SLSTMBlock(cfg.d_model, cfg.n_heads)
    raise ValueError(f"unknown block kind {kind!r}")


@dataclasses.dataclass(frozen=True)
class DecoderLM(Module):
    """Decoder LM over segments of stacked dense, MoE, Mamba2, mLSTM or
    sLSTM blocks, with an optional Zamba-style weight-tied shared block and
    an optional modality-frontend projector (prefix embeddings); tied or
    untied head."""

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
        if cfg.frontend_dim:
            p["frontend_proj"] = mk.child("frontend_proj", self._frontend())
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

    def _frontend(self) -> Linear:
        """The modality projector: frontend_dim -> d_model, on the MX
        dispatch (JAX: a `Linear`)."""
        return Linear(self.cfg.frontend_dim, self.cfg.d_model)

    def _embed_inputs(self, p, tokens, prefix_embeds=None):
        """Token embeddings (B, S, D), after the projected prefix embeddings
        (B, P, frontend_dim) when given: (B, P + S, D)."""
        x = Embedding(self.cfg.vocab, self.cfg.d_model)(p["embed"], tokens)
        if prefix_embeds is None:
            return x
        pre = self._frontend()(p["frontend_proj"], prefix_embeds.to(x.dtype))
        return torch.cat([pre, x], dim=1)

    def _head(self, p, x):
        """Final norm + LM head -> f32 logits.  The tied head is the plain
        `x @ table.T`; an untied head rides the MX dispatch."""
        cfg = self.cfg
        x = rms_norm(x, p["ln_f"])
        if cfg.tie_embeddings:
            return Embedding(cfg.vocab, cfg.d_model).attend(p["embed"], x)
        return ops.linear(x, p["lm_head"], out_dtype=torch.float32,
                          tp_mode="allgather")

    def __call__(self, p, tokens, *, prefix_embeds=None):
        """tokens: (B, S) -> (logits (B, P + S, vocab) f32, aux loss): the
        sum of the MoE blocks' load-balancing losses (0 for dense, state and
        shared blocks).  P is prefix_embeds' length (0 without)."""
        x = self._embed_inputs(p, tokens, prefix_embeds)
        aux = torch.zeros((), device=x.device)
        for i, seg in enumerate(self.segments()):
            block = make_block(seg.kind, self.cfg)
            for what, j in self._walk(seg):
                if what == "shared":
                    x, a = self._shared_block()(p["shared"], x)  # tied weights
                elif seg.kind in STATE_KINDS:
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
        a state block's f32 recurrent state (init_state: zeros, and the
        xLSTM maxima at -1e30) --, "shared{i}": the shared block's K/V per
        application (after each group of a segment)}."""
        cfg = self.cfg
        cache = {}
        for i, seg in enumerate(self.segments()):
            block = make_block(seg.kind, cfg)
            if seg.kind in STATE_KINDS:
                one = block.init_state(batch, device=device)
            else:
                one = block.init_cache(batch, max_len, dtype=dtype, device=device)
            cache[f"seg{i}"] = _stacked(one, seg.n)
            if cfg.shared_attn_every:
                one = self._shared_block().init_cache(batch, max_len, dtype=dtype,
                                                      device=device)
                cache[f"shared{i}"] = _stacked(one, seg.n // cfg.shared_attn_every)
        return cache

    def supports_chunked_prefill(self) -> bool:
        """`prefill_step` covers attention-only segments (state-block,
        shared-block and prefix models step their prompts token by token,
        as in JAX)."""
        return self.supports_paged()

    def decode_step(self, p, token, cache, index, *, prefix_embeds=None):
        """One token for the whole stack against the dense cache.  token:
        (B, 1); index: a scalar position or (B,) per-slot positions.
        Returns (logits (B, 1, V) f32, cache), the cache updated in place.
        A prefix is refused: JAX's decode_step(prefix_embeds=) raises a
        TypeError (Attention.decode reshapes P + 1 rows as one token), and
        JAX runs a prefix through the full forward only."""
        if prefix_embeds is not None:
            raise ValueError(
                f"{self.cfg.name}: decode_step takes no prefix_embeds (JAX's raises a "
                "TypeError there); run the prefix through the full forward, "
                "__call__(prefix_embeds=) / launch.steps.make_prefill_step")
        x = self._embed_inputs(p, token)
        for i, seg in enumerate(self.segments()):
            block = make_block(seg.kind, self.cfg)
            for what, j in self._walk(seg):
                if what == "shared":
                    x, _ = self._shared_block().decode(
                        p["shared"], x, layer_slice(cache[f"shared{i}"], j), index)
                elif seg.kind in STATE_KINDS:
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
            cache[f"seg{i}"] = _stacked(one, seg.n)
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


@dataclasses.dataclass(frozen=True)
class EncDecLM(Module):
    """Encoder-decoder (seamless-m4t's backbone; the speech frontend is a
    stub that hands over precomputed frame embeddings).  The encoder is
    `enc_layers` non-causal blocks over frontend_proj(frames); the decoder
    `n_layers` "encdec" blocks, each cross-attending over its own K/V of
    the encoder output; tied head."""

    cfg: Any

    def _enc_block(self) -> TransformerBlock:
        """JAX builds it without the config's precision, rope theta or
        chunk threshold."""
        cfg = self.cfg
        return TransformerBlock(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
                                head_dim=cfg.head_dim, causal=False, activation=cfg.activation)

    def build(self, mk: Builder):
        cfg = self.cfg
        return {
            "frontend_proj": mk.child("frontend_proj", Linear(cfg.frontend_dim, cfg.d_model)),
            "embed": mk.child("embed", Embedding(cfg.vocab, cfg.d_model)),
            "enc": mk.stacked("enc", self._enc_block(), cfg.enc_layers),
            "enc_ln": mk.param("enc_ln", (cfg.d_model,), init="ones"),
            "dec": mk.stacked("dec", make_block("encdec", cfg), cfg.n_layers),
            "ln_f": mk.param("ln_f", (cfg.d_model,), init="ones"),
        }

    def encode(self, p, frames):
        """frames: (B, S_enc, frontend_dim) precomputed modality embeddings
        -> the normed encoder output (B, S_enc, D)."""
        cfg = self.cfg
        x = Linear(cfg.frontend_dim, cfg.d_model)(p["frontend_proj"], frames)
        block = self._enc_block()
        for layer in range(cfg.enc_layers):
            x, _ = block(layer_slice(p["enc"], layer), x)
        return rms_norm(x, p["enc_ln"])

    @staticmethod
    def _enc_kv(p_layer, enc_out, block):
        """A decoder layer's cross K and V (B, S_enc, Hkv, hd) of the
        encoder output, two MX GEMMs (`ops.matmul`, as in JAX).  JAX repeats
        them to H heads here; the attention reads kv head h // (H / Hkv)
        itself."""
        b, s, _ = enc_out.shape
        hd = block.head_dim or block.d_model // block.n_heads
        att = p_layer["xattn"]
        k = ops.matmul(enc_out, att["wk"], out_dtype=enc_out.dtype)
        v = ops.matmul(enc_out, att["wv"], out_dtype=enc_out.dtype)
        return (k.reshape(b, s, block.n_kv_heads, hd), v.reshape(b, s, block.n_kv_heads, hd))

    def _head(self, p, x):
        return Embedding(self.cfg.vocab, self.cfg.d_model).attend(p["embed"],
                                                                  rms_norm(x, p["ln_f"]))

    def __call__(self, p, frames, tokens):
        """(frames (B, S_enc, frontend_dim), tokens (B, S)) -> (decoder
        logits (B, S, vocab) f32, aux 0)."""
        cfg = self.cfg
        enc_out = self.encode(p, frames)
        x = Embedding(cfg.vocab, cfg.d_model)(p["embed"], tokens)
        block = make_block("encdec", cfg)
        aux = torch.zeros((), device=x.device)
        for layer in range(cfg.n_layers):
            lp = layer_slice(p["dec"], layer)
            x, a = block(lp, x, enc_kv=self._enc_kv(lp, enc_out, block))
            aux = aux + a
        return self._head(p, x), aux

    def make_cache(self, batch: int, max_len: int, *, dtype=torch.bfloat16,
                   device="cuda"):
        """{"dec": the decoder's self-attention K/V, (n_layers, batch,
        max_len, Hkv, hd) of `dtype`, zeroed}; the cross K/V is no cache."""
        one = make_block("encdec", self.cfg).init_cache(batch, max_len, dtype=dtype,
                                                        device=device)
        return {"dec": _stacked(one, self.cfg.n_layers)}

    def decode_step(self, p, token, cache, index, *, enc_out):
        """One decoder token against the dense cache and the encoder output
        (B, S_enc, D).  Returns (logits (B, 1, V) f32, cache), the cache
        updated in place."""
        cfg = self.cfg
        x = Embedding(cfg.vocab, cfg.d_model)(p["embed"], token)
        block = make_block("encdec", cfg)
        for layer in range(cfg.n_layers):
            lp = layer_slice(p["dec"], layer)
            x, _ = block.decode(lp, x, layer_slice(cache["dec"], layer), index,
                                enc_kv=self._enc_kv(lp, enc_out, block))
        return self._head(p, x), cache


def build_model(cfg):
    """ArchConfig -> model module: `EncDecLM` for an encoder-decoder,
    `DecoderLM` otherwise (as `repro.models.build_model`)."""
    if cfg.model_kind == "encdec":
        return EncDecLM(cfg)
    return DecoderLM(cfg)
