"""Step functions of the serving path (port of `repro/launch/steps.py`'s
prefill and serve step builders).

JAX builds these for `jax.jit` and the dry-run; the port runs them eagerly,
so each builder returns a plain closure.  Training steps come with the
trainer (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

from typing import Callable


def forward(model, cfg, params, batch):
    """(logits, aux) of the full forward.  Decoder LMs only: the
    encoder-decoder and prefix-embedding inputs are not ported yet."""
    if cfg.model_kind == "encdec" or cfg.frontend_dim:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder and prefix-embedding "
                                  "forwards are not ported yet (ROADMAP queue 1)")
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
    """(params, cache, token, index) -> (logits, cache): one token against
    the dense cache / recurrent state of a decoder LM."""
    if cfg.model_kind == "encdec":
        raise NotImplementedError("encoder-decoder serving is not ported yet "
                                  "(ROADMAP queue 1 item 5)")

    def serve_step(params, cache, token, index):
        return model.decode_step(params, token, cache, index)

    return serve_step
