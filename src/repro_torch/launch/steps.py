"""Step functions of the serving path (port of `repro/launch/steps.py`'s
prefill and serve step builders).

JAX builds these for `jax.jit` and the dry-run; the port runs them eagerly,
so each builder returns a plain closure.  Training steps come with the
trainer (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

from typing import Callable


def forward(model, cfg, params, batch):
    """(logits, aux) of the full forward, the logits at the label positions
    only (JAX's three input conventions): an encoder-decoder takes
    batch["frames"] and batch["tokens"]; a prefix-embedding model (VLM)
    batch["tokens"] after batch["pixel_embeds"], its logits cut to the
    text positions; a decoder LM batch["tokens"]."""
    if cfg.model_kind == "encdec":
        return model(params, batch["frames"], batch["tokens"])
    if cfg.frontend_dim:
        logits, aux = model(params, batch["tokens"], prefix_embeds=batch["pixel_embeds"])
        return logits[:, cfg.frontend_tokens:, :], aux
    return model(params, batch["tokens"])


def make_prefill_step(model, cfg) -> Callable:
    """(params, batch) -> logits: the cacheless full-sequence forward
    (inference prefill)."""

    def prefill_step(params, batch):
        logits, _ = forward(model, cfg, params, batch)
        return logits

    return prefill_step


def make_chunked_prefill_step(model, cfg) -> Callable:
    """(params, cache, tokens, index) -> (logits, cache): one (B, chunk)
    token block through the stack, writing dense cache rows [index,
    index+chunk).  Attention-only decoders (`model.supports_chunked_prefill`)."""
    if cfg.model_kind == "encdec":
        raise ValueError("chunked prefill is decoder-only")

    def prefill_step(params, cache, tokens, index):
        return model.prefill_step(params, tokens, cache, index)

    return prefill_step


def make_serve_step(model, cfg) -> Callable:
    """One token against the dense cache / recurrent state.
      decoder LM:      (params, cache, token, index) -> (logits, cache)
      encoder-decoder: (params, cache, token, index, enc_out) -> (logits, cache)"""
    if cfg.model_kind == "encdec":

        def serve_step(params, cache, token, index, enc_out):
            return model.decode_step(params, token, cache, index, enc_out=enc_out)

        return serve_step

    def serve_step(params, cache, token, index):
        return model.decode_step(params, token, cache, index)

    return serve_step
