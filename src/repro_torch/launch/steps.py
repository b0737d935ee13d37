"""Step functions (port of `repro/launch/steps.py`): the train step and
the prefill and serve step builders.

JAX builds these for `jax.jit` and the dry-run; the port runs them eagerly,
so each builder returns a plain closure.  The train step differentiates
the plain PyTorch path with autograd, under `MXPolicy("torch")` on every
device, as JAX trains on its "xla" backend: the CUDA kernels have no
backward (nor can `jax.grad` transpose JAX's Pallas kernels), and they
refuse a grad-enabled operand that requires grad (`kernels/_build.
refuse_grad`).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core import ops
from ..core import tree as tree_util
from ..optim.adamw import AdamW


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


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE; logits f32 (B, S, V), labels int (B, S)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def batch_to(batch, device) -> dict:
    """A batch of numpy arrays (`data/pipeline.SyntheticLM`) or tensors on
    `device`."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray)
                else v).to(device) for k, v in batch.items()}


def value_and_grad(model, cfg, params, batch):
    """((loss + aux), {"loss", "aux_loss"}, grads) of one batch on the plain
    path under autograd: grads is a tree like params (zeros for a leaf the
    loss does not reach, as JAX's)."""
    p_leaves = tree_util.leaves(params)
    leaves = [p.detach().requires_grad_(p.is_floating_point()) for p in p_leaves]
    live = tree_util.unflatten(params, leaves)
    with torch.enable_grad(), ops.use_policy(ops.MXPolicy("torch")):
        logits, aux = forward(model, cfg, live, batch)
        loss = cross_entropy(logits, batch["labels"])
        aux = torch.as_tensor(aux, dtype=loss.dtype, device=loss.device)
        total = loss + aux
        wrt = [x for x in leaves if x.requires_grad]
        got = iter(torch.autograd.grad(total, wrt, allow_unused=True))
    grads = [None if not x.requires_grad else next(got) for x in leaves]
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(p_leaves, grads)]
    return (total.detach(), {"loss": loss.detach(), "aux_loss": aux.detach()},
            tree_util.unflatten(params, grads))


def make_train_step(model, cfg, opt: AdamW, *, microbatch: int = 1,
                    inplace: bool = False) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), metrics
    {"loss", "aux_loss", "grad_norm", "lr"} as 0-d tensors.  The batch may
    be numpy (it moves to the parameters' device).

    `microbatch > 1` accumulates the gradients of `microbatch` equal slices
    of the batch in order (in f32), divides by `microbatch` and averages
    the metrics, as JAX's scan does.  `inplace` updates the given
    parameters and optimizer state in place (`AdamW.update`), the port's
    counterpart of JAX's donated buffers; the bits are the functional
    form's."""

    def train_step(params, opt_state, batch):
        device = next(iter(tree_util.leaves(params))).device
        batch = batch_to(batch, device)
        if microbatch == 1:
            _, metrics, grads = value_and_grad(model, cfg, params, batch)
        else:
            gsum, per = None, []
            for i in range(microbatch):
                mb = {k: v[i * (len(v) // microbatch):(i + 1) * (len(v) // microbatch)]
                      for k, v in batch.items()}
                _, m, g = value_and_grad(model, cfg, params, mb)
                per.append(m)
                if gsum is None:
                    gsum = tree_util.map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                                               device=x.device), g)
                gsum = tree_util.map(torch.add, gsum, g)
                del g  # freed before the next slice's forward
            grads = tree_util.map(lambda x: x / microbatch, gsum)
            metrics = {k: torch.stack([m[k] for m in per]).mean() for k in per[0]}
        params, opt_state, opt_metrics = opt.update(grads, opt_state, params,
                                                    inplace=inplace)
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step


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
