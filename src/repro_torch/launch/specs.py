"""Meta-tensor stand-ins and specs for every (arch x shape) cell (port of
`repro/launch/specs.py`).

Nothing here allocates storage: every argument is a tensor on the "meta"
device, which carries a shape and a dtype only (JAX's `ShapeDtypeStruct`),
and full-scale steps run on them under `core/op_census.py`.  The specs are
the port's own tuples from `parallel/sharding.tree_specs` (JAX's
`NamedSharding`s): a process of the port holds whole tensors, so a spec
says how a mesh would split a leaf, for `launch/dryrun.py`'s per-device
argument bytes.

Sequence conventions (JAX's):
  decoder LM   train/prefill: tokens (B, S)
  VLM          frontend_tokens patch embeddings prefix + (S - P) text tokens
  enc-dec      S/2 modality frames into the encoder + S/2 decoder tokens
  decode       one token against a seq_len cache; enc-dec adds enc_out
               (B, 4096, d_model) cross-attention memory

The decode index is a Python int (the last cache row), which the dense
cache writes without reading a tensor back (`models/layers.Attention.
decode`); JAX's is a traced int32 scalar.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..configs.shapes import ShapePreset
from ..models import build_model
from ..optim.adamw import AdamW, AdamWState
from ..parallel.sharding import AxisRules, tree_specs

ENC_LEN_DECODE = 4_096  # encoder memory length for enc-dec decode shapes
META = torch.device("meta")


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


@dataclasses.dataclass
class CellSpecs:
    """Everything needed to run one (arch, shape, mesh) cell on meta."""

    kind: str  # train | prefill | decode
    args: Tuple[Any, ...]  # meta arguments in step-function order
    in_specs: Tuple[Any, ...]
    out_specs: Any
    donate_argnums: Tuple[int, ...]  # updated in place by the port's step
    tokens_per_step: int  # for MODEL_FLOPS


def _batch_specs(cfg: ArchConfig, preset: ShapePreset, rules: AxisRules,
                 with_labels: bool):
    B, S = preset.global_batch, preset.seq_len
    batch: Dict[str, Any] = {}
    spec: Dict[str, Any] = {}

    def add(name, shape, dtype, axes):
        batch[name] = meta(shape, dtype)
        spec[name] = rules.spec(shape, axes)

    if cfg.model_kind == "encdec":
        se = S // 2
        add("frames", (B, se, cfg.frontend_dim), torch.bfloat16, ("batch", None, None))
        n_text, n_tok = se, B * se
    elif cfg.frontend_dim:
        P = cfg.frontend_tokens
        add("pixel_embeds", (B, P, cfg.frontend_dim), torch.bfloat16, ("batch", None, None))
        n_text, n_tok = S - P, B * S
    else:
        n_text, n_tok = S, B * S
    add("tokens", (B, n_text), torch.int32, ("batch", None))
    if with_labels:
        add("labels", (B, n_text), torch.int32, ("batch", None))
    return batch, spec, n_tok


def cell_specs(cfg: ArchConfig, preset: ShapePreset, rules: AxisRules, *,
               param_dtype=torch.bfloat16, opt: Optional[AdamW] = None) -> CellSpecs:
    model = build_model(cfg)
    params = model.init(0, device=META, dtype=param_dtype)
    paxes = model.axes()
    pspec = tree_specs(rules, params, paxes)

    if preset.kind == "train":
        assert opt is not None
        state = opt.init(params)
        ospec = AdamWState(count=rules.spec((), ()), m=tree_specs(rules, state.m, paxes),
                           v=tree_specs(rules, state.v, paxes))
        batch, bspec, n_tok = _batch_specs(cfg, preset, rules, with_labels=True)
        return CellSpecs(kind="train", args=(params, state, batch),
                         in_specs=(pspec, ospec, bspec), out_specs=(pspec, ospec, None),
                         donate_argnums=(0, 1), tokens_per_step=n_tok)

    if preset.kind == "prefill":
        batch, bspec, n_tok = _batch_specs(cfg, preset, rules, with_labels=False)
        B = preset.global_batch
        S = batch["tokens"].shape[1] + (
            cfg.frontend_tokens if cfg.frontend_dim and cfg.model_kind != "encdec" else 0)
        return CellSpecs(kind="prefill", args=(params, batch), in_specs=(pspec, bspec),
                         out_specs=rules.spec((B, S, cfg.vocab), ("batch", None, "vocab")),
                         donate_argnums=(), tokens_per_step=n_tok)

    # ---- decode ----
    B, S = preset.global_batch, preset.seq_len
    cache = model.make_cache(B, S, device=META)
    cspec = tree_specs(rules, cache, model.cache_axes())
    args = [params, cache, meta((B, 1), torch.int32), S - 1]
    in_specs = [pspec, cspec, rules.spec((B, 1), ("batch", None)), ()]
    if cfg.model_kind == "encdec":
        enc_shape = (B, ENC_LEN_DECODE, cfg.d_model)
        args.append(meta(enc_shape, torch.bfloat16))
        in_specs.append(rules.spec(enc_shape, ("batch", None, None)))
    logits = rules.spec((B, 1, cfg.vocab), ("batch", None, "vocab"))
    return CellSpecs(kind="decode", args=tuple(args), in_specs=tuple(in_specs),
                     out_specs=(logits, cspec), donate_argnums=(1,), tokens_per_step=B)
